"""What the ported tools share: the device flag, SimConfig override
strings, the hot state, advancing a state, timing, counting the aten ops
a call dispatches, the Morton-sorted padded inputs of a band build, the
runner's first rebuild, a direct sum and band-count quantiles.

A tool's measuring function takes a ParticleState and a SimConfig and
returns a dict; its ``main(argv)`` parses the JAX tool's arguments (each
environment knob of the JAX tool a flag), advances or loads the state,
calls the function and prints the JAX tool's lines.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Iterable, Optional

import torch

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.models.simulation import _adaptive_rebuild_fn, \
    _pad_cycle_state, sort_by_morton
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.utils.io import load_checkpoint
from nbody_tpu_torch.utils.profiling import _sync, time_fn

# Where prof_mkhot writes the hot state and the hot-state tools read it
# by default (the JAX tools use files under /tmp).
HOT_STATE = os.path.join("chip_scratch", "hot1m.npz")


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (the "
                         "kernels' plain versions)")


def device_of(name: str) -> torch.device:
    """The tool's device; CUDA raises when no GPU is present."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass --device cpu to "
                           "run the plain versions on the CPU")
    return dev


def parse_overrides(spec) -> Dict:
    """SimConfig overrides from "k=v,k=v" (or an iterable of "k=v"), each
    value typed by its field as the JAX tools type it: bool from 1/true,
    else float or int."""
    items = spec.split(",") if isinstance(spec, str) else list(spec)
    fields = SimConfig.__dataclass_fields__
    out = {}
    for kv in filter(None, items):
        k, v = kv.split("=")
        if k not in fields:
            raise ValueError(f"unknown SimConfig field {k!r}")
        t = str(fields[k].type)
        out[k] = (v.lower() in ("1", "true")) if "bool" in t else (
            float(v) if "float" in t else int(v))
    return out


def parse_caps(spec: str) -> Dict:
    """"sup,mid,cmid,near" cap values as SimConfig fields."""
    s, m, c, n = (int(x) for x in spec.split(","))
    return dict(sup_cap=s, mid_cap=m, cmid_cap=c, near_cap=n)


def load_state(hot: str, n: int = 1_000_000, device=None):
    """(state, step): the npz checkpoint at `hot` (either package's), or
    with hot == "IC" the initial conditions of v5_bench at n bodies."""
    if hot == "IC":
        from nbody_tpu_torch.init import make_initial_state

        return make_initial_state(PRESETS["v5_bench"].replace(n=n),
                                  device=device), 0
    return load_checkpoint(hot, device=device)


def advance(sim, state: ParticleState, steps: int, chunk: int = 128,
            log: Optional[Callable[[str], None]] = print) -> ParticleState:
    """`steps` steps of sim.run_scan in calls of at most `chunk`, with an
    "advanced k" line after each call."""
    done = 0
    while done < steps:
        k = min(chunk, steps - done)
        state = sim.run_scan(state, k)
        _sync(state)
        done += k
        if log is not None:
            log(f"  advanced {done}")
    return state


def device_ms(fn: Callable, device: torch.device, iters: int = 5,
              warmup: int = 1) -> float:
    """ms of fn() on `device`: on CUDA the mean from events around
    `iters` calls after `warmup` calls; on the CPU the median host time
    (time_fn)."""
    if device.type != "cuda":
        return time_fn(fn, iters=iters, warmup=warmup)["median_ms"]
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def device_times(fn: Callable, device: torch.device, iters: int = 6,
                 warmup: int = 1) -> Dict:
    """{"median_ms", "min_ms"} of fn() on `device`, each of `iters` calls
    after `warmup` calls timed alone: on CUDA between its own pair of
    events (one synchronisation after the last call), on the CPU on the
    host clock (time_fn)."""
    if device.type != "cuda":
        t = time_fn(fn, iters=iters, warmup=warmup)
        return {"median_ms": t["median_ms"], "min_ms": t["min_ms"]}
    for _ in range(warmup):
        fn()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(iters)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    times = sorted(s.elapsed_time(e) for s, e in marks)
    return {"median_ms": times[len(times) // 2], "min_ms": times[0]}


def op_count(fn: Callable) -> int:
    """The aten ops that fn() dispatches, views left out: each launches
    one kernel or more on CUDA (a sort several), a view none."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


def sorted_padded(state: ParticleState, cfg: SimConfig):
    """(ps, ms, cs, perm, lo, size): the build's Morton-sorted,
    tile-padded positions, masses and codes (cfg.morton_bits), the
    permutation and the cube the codes were quantized against."""
    codes_s, perm, lo, size = sort_by_morton(state.pos, cfg)
    ps, ms, cs = forces.pad_sorted(state.pos[perm], state.mass[perm],
                                   codes_s, cfg.force_tile)
    return ps, ms, cs, perm, lo, size


def first_rebuild(state: ParticleState, cfg: SimConfig):
    """(rebuild, args): the adaptive runner's rebuild and its inputs at
    `state` with k_env = K (the first rebuild of a run_scan call that
    starts again, envelopes for cfg.rebuild_every steps).  rebuild(*args)
    returns ((pos, vel, mass, acc, orig, afm), (cells, ss, bands, tables,
    rctx), (s_valid, report)) in the new (sorted, tile-padded) order, as
    models.simulation._adaptive_rebuild_fn says."""
    args = _pad_cycle_state(state, cfg.force_tile) + (
        torch.full((), cfg.rebuild_every, device=state.device),)
    return _adaptive_rebuild_fn(cfg), args


def direct_sum(state: ParticleState, cfg: SimConfig,
               rows: Optional[torch.Tensor] = None, dtype=torch.float32,
               block: int = 1024) -> torch.Tensor:
    """Direct-sum accelerations of every body (or of `rows`) from every
    body, in `dtype`, in forces.direct_forces's panels (the self term adds
    exactly zero)."""
    pos, mass = state.pos.to(dtype), state.mass.to(dtype)
    tgt = pos if rows is None else pos[rows]
    g, soft = cfg.g, forces.soft_term(cfg)
    src_block = max(block, forces._PANEL_ELEMS // block)
    out = []
    for i in range(0, tgt.shape[0], block):
        acc = torch.zeros_like(tgt[i:i + block])
        for j in range(0, state.n, src_block):
            acc += forces._panel_accel(tgt[i:i + block],
                                       pos[j:j + src_block],
                                       mass[j:j + src_block], g, soft)
        out.append(acc)
    return torch.cat(out)


def norms_padded(x: torch.Tensor, npad: int) -> torch.Tensor:
    """|x| of each row, zero-padded to npad rows."""
    v = torch.sqrt((x ** 2).sum(dim=1))
    return torch.cat([v, v.new_zeros(npad - v.shape[0])])


def clone_padded(x: torch.Tensor, npad: int) -> torch.Tensor:
    """[n, 3] rows padded to npad with clones of the last row."""
    return torch.cat([x, x[-1:].expand(npad - x.shape[0], 3)])


def capped_drift(v: torch.Tensor, cfg: SimConfig, k: int) -> torch.Tensor:
    """The older tools' skin: min(v dt k skin_safety, max_speed dt k)."""
    return torch.clamp(v * cfg.dt * k * cfg.skin_safety,
                       max=cfg.max_speed * cfg.dt * k)


def quantiles(x: torch.Tensor) -> Dict:
    """mean, p999 and max of a per-tile count (the JAX tools' q(): the
    sorted value at int(0.999 (T - 1)))."""
    xs = torch.sort(x.reshape(-1)).values
    return {"mean": float(x.to(torch.float32).mean()),
            "p999": int(xs[int(0.999 * (xs.shape[0] - 1))]),
            "max": int(xs[-1])}


# the JAX tools' band names and the CellBands fields they read
COUNTS = {"ss": "ss_cnt", "sup": "sup_cnt", "mid": "mid_cnt",
          "cmid": "cmid_cnt", "near": "near_cnt", "wins": "win_cnt"}


# the seven overflow flags of a build, in the JAX tools' order
FLAGS = ("ss", "sup", "mid", "cmid", "near", "cells", "g2")


def overflow_flags(cells, bands) -> Dict:
    """{flag: bool} of the band caps, the cell capacity and the
    grandchild cap."""
    out = {k: bool(getattr(bands, f"{k}_overflow")) for k in FLAGS[:5]}
    out.update(cells=bool(cells.overflow), g2=bool(cells.overflow_g2))
    return out


def band_quantiles(bands, names: Iterable[str]) -> Dict:
    return {k: quantiles(getattr(bands, COUNTS[k])) for k in names}


def quantile_text(names: Iterable[str], q: Dict) -> str:
    """The JAX tools' "name mean/p999 p/max m" fields."""
    return "  ".join(f"{k} {q[k]['mean']:.0f}/p999 {q[k]['p999']}/max "
                     f"{q[k]['max']}" for k in names)
