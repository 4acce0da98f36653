"""Benchmark harness: per-frame and per-phase timing, a profiler trace,
the program's spans in it, and host <-> device transfer rates.

The nbody_v5_bench loop (nbody_v5_bench.cu:346-366: cudaEvent timing
around each simulationStep and a `Frame | ms | FPS` table) becomes host
timing around a step that ends in a device synchronisation; the
per-phase breakdown (sort, band build, the three sweeps, integrate) times
each stage on its own.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import torch
from torch.autograd import profiler as autograd_profiler

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState, default_device


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def _sync(x) -> None:
    """Wait for the device of the first tensor in `x` (a tensor, a
    ParticleState or a nested tuple) to finish its work."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_fn(fn: Callable, *args, iters: int = 10,
            warmup: int = 2) -> Dict[str, float]:
    """Median, mean, min and max host ms of fn(*args), each call ending in
    a device synchronisation."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {
        "median_ms": times[len(times) // 2],
        "mean_ms": sum(times) / len(times),
        "min_ms": times[0],
        "max_ms": times[-1],
    }


def frame_table(step_fn: Callable[[ParticleState], ParticleState],
                state: ParticleState, n_frames: int, print_every: int = 1,
                printer=print) -> List[Dict[str, float]]:
    """The reference bench loop: per-frame ms and FPS, one device
    synchronisation per frame (cudaEventSynchronize,
    nbody_v5_bench.cu:360)."""
    rows = []
    printer(f"{'Frame':<10} | {'Time (ms)':<15} | {'FPS':<10}")
    printer("-" * 42)
    for frame in range(n_frames):
        t0 = time.perf_counter()
        state = step_fn(state)
        _sync(state)
        ms = (time.perf_counter() - t0) * 1e3
        fps = 1000.0 / ms if ms > 0 else float("inf")
        rows.append({"frame": frame, "ms": ms, "fps": fps})
        if print_every and frame % print_every == 0:
            printer(f"{frame:<10} | {ms:<15.3f} | {fps:<10.1f}")
    return rows


def phase_times(state: ParticleState, cfg: SimConfig, iters: int = 10,
                include_tree: bool = False) -> Dict[str, float]:
    """Median ms per phase of one per-step-rebuild step: bounding cube,
    Morton codes and sort / band build / far / mid (table) / near /
    integrate, each timed on its own, so the sum exceeds a step.  The
    sweeps are the hand kernels when cfg.use_pallas holds and the state
    lies on CUDA, the plain versions otherwise.  `include_tree` adds the
    rope-walk oracle's tree build, which the production step does not
    run."""
    from nbody_tpu_torch.models.simulation import sort_by_morton
    from nbody_tpu_torch.ops import forces, integrate as integ
    from nbody_tpu_torch.ops.tree import build_tree

    pos, mass = state.pos, state.mass
    codes_s, perm, _, size = sort_by_morton(pos, cfg)
    pos_s, mass_s = pos[perm], mass[perm]
    b = cfg.force_tile
    pos_p, mass_p, codes_p = forces.pad_sorted(pos_s, mass_s, codes_s, b)
    _, far, bands, tables = forces.build_bands(pos_p, mass_p, codes_p, cfg)

    if cfg.use_pallas and pos.device.type == "cuda":
        from nbody_tpu_torch.ops.cuda import forces as kern

        far_fn, mid_fn, near_fn = (kern.far_sweep, kern.table_sweep,
                                   kern.near_span)
    else:
        far_fn, mid_fn, near_fn = (forces.far_sweep_torch,
                                   forces.table_sweep_torch,
                                   forces.near_correction_torch)

    def near():
        return near_fn(pos_p, pos_p, mass_p, bands.win_first, bands.win_mask,
                       bands.win_cnt, cfg)

    acc_s = (far_fn(pos_p, far, cfg) + mid_fn(pos_p, tables, cfg)
             + near())[:pos.shape[0]]
    acc = torch.empty_like(acc_s)
    acc[perm] = acc_s

    out = {
        "sort_ms": time_fn(lambda: sort_by_morton(pos, cfg),
                           iters=iters)["median_ms"],
        "groups_ms": time_fn(lambda: forces.build_bands(pos_p, mass_p,
                                                        codes_p, cfg),
                             iters=iters)["median_ms"],
        "far_ms": time_fn(lambda: far_fn(pos_p, far, cfg),
                          iters=iters)["median_ms"],
        "mid_ms": time_fn(lambda: mid_fn(pos_p, tables, cfg),
                          iters=iters)["median_ms"],
        "near_ms": time_fn(near, iters=iters)["median_ms"],
        "integrate_ms": time_fn(lambda: integ.integrate(state, acc, cfg),
                                iters=iters)["median_ms"],
    }
    if include_tree:
        codes30 = ((codes_s >> 33) & 0x3FFFFFFF if cfg.morton_bits == 63
                   else codes_s)
        out["tree_ms"] = time_fn(lambda: build_tree(codes30, pos_s, mass_s,
                                                    size),
                                 iters=iters)["median_ms"]
    return out


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named `name` in the active torch.profiler session
    (``record_function``), or, with no session active, one shared no-op
    context: with tracing off a span costs an attribute read and a
    ``with``.  The program's spans are named ``nbody.*``; a graph's
    kernels carry the correlation id of their ``cudaGraphLaunch``, so in
    the trace each device op belongs to the innermost span that holds
    its launch."""
    if autograd_profiler._is_profiler_enabled:
        return autograd_profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """One torch.profiler session (CPU, and CUDA when present) around the
    block, exported as a Chrome trace to log_dir/trace.json (view it in
    chrome://tracing or Perfetto).  A second session in the same process
    has come back without some of its kernels; trace once per process."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def transfer_bench(n_bytes: int = 1 << 26, iters: int = 5,
                   device=None) -> Dict[str, float]:
    """Host <-> device copy rates from pageable host memory (the 'CPU-GPU
    memory transfer benchmarks' the reference README advertises,
    README.md:27), on `device` (CUDA unless asked otherwise)."""
    device = default_device(device)
    x = torch.ones(n_bytes // 4, dtype=torch.float32)
    d = x.to(device)
    _sync(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        d = x.to(device)
        _sync(d)
    h2d = n_bytes * iters / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(iters):
        _ = d.cpu()
    d2h = n_bytes * iters / (time.perf_counter() - t0)
    return {"h2d_gbps": h2d / 1e9, "d2h_gbps": d2h / 1e9, "mb": n_bytes / 1e6}
