"""The port's benchmark line (counterpart of the root bench.py): steps/s of
the adaptive runner at a preset on one card, the work its force kernels
do, the energy drift over a kilostep and each kernel against its plain
version.

    python -m nbody_tpu_torch.bench [--preset v5_bench] [--n N]
        [--frames 32] [--k K] [--tile B] [--r R] [--span 0|1]
        [--caps sup_cap:320,cmid_cap:768] [--over "k=v,k=v"] [--phases]
        [--drift-steps 1000] [--skip-drift] [--skip-selfcheck]
        [--device cuda]

The flags are bench.py's environment knobs (NBODY_BENCH_PRESET, _N,
_FRAMES, _K, _TILE, _R, _SPAN, _CAPS, _OVER, _PHASES, _DRIFT_STEPS,
_SKIP_DRIFT, _SKIP_SELFCHECK).  --device defaults to cuda and raises without a GPU; --device cpu runs
the kernels' plain versions (no selfcheck, no launch counts).

Prints ONE JSON line on stdout; every other line goes to stderr.  A
phase that fails raises, and the process exits non-zero.  Fields:
  value            median steps/s of TIMED_CALLS sim.run_scan(state,
                   frames) calls, each from the same state (after a
                   warm-up step, the dispatched steps and one untimed
                   call); value_spread = (max - min) / median of them
  gflops, mfu      executed FP32 operations a step over the step time,
                   and that rate over PEAK_FP32 (null on the CPU);
                   gflops_useful counts live pairs only; both from `work`
                   on the structure the timed calls sweep first
  near_lane_occupancy  live near lanes over the lanes near_span sweeps
  overflow_*       the band caps, the cell capacity and the grandchild
                   cap at that structure
  drift, drift_steps, drift_ok, value_hot, value_avg_1k
                   metrics.drift_protocol from the initial conditions
                   (E0 at entry) in chunks of `frames`, as the kilostep
                   gate runs it; drift past DRIFT_LIMIT raises
  selfcheck_{far,mid,near}[_t128]  max over targets of |kernel - plain| /
                   (|plain| + 1e-6) at n = 50,000 (on CUDA only)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from typing import Dict

import torch

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.ops.cuda import forces as kern
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools.prof_nearwin import live_lanes, popcount32
from nbody_tpu_torch.utils import metrics
from nbody_tpu_torch.utils.profiling import _sync, phase_times

# H100 SXM published peaks: FP32 outside the tensor cores and HBM
# bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_PAIR = 20        # 3 sub, 3 mul + 3 add (d2 + soft), sqrt,
                           # division, 3 mul (m * inv^3), 3 mul + 3 add
                           # (the terms and their sums), one op each
# max over targets of |kernel - plain| / (|total plain acceleration| + 1e-6)
BOUNDS = {"far_sweep": 1e-4, "table_sweep": 5e-4, "near_span": 1e-4}
DRIFT_LIMIT = 0.01         # enforced: a broken schedule drifts 6.6-13%
DRIFT_CRITERION = 0.002    # the BASELINE.json criterion, reported
SELFCHECK_N = 50_000
TIMED_CALLS = 5
SELFCHECK_NAMES = {"far_sweep": "far", "table_sweep": "mid",
                   "near_span": "near"}

# The loop bounds of csrc/tile_sweeps.cu that `work` counts executed pairs
# from: kThreads threads a block; the per-tile sweeps hold up to
# kMaxTargets targets a thread (targets_per_thread); every swept run of
# sources is padded to a multiple of kPad with massless sources; the far
# sweep stages its live list kFarChunk at a time and holds kFarTargets
# targets a thread.
K_THREADS = 128
K_MAX_TARGETS = 4
K_PAD = 8
K_FAR_CHUNK = 1024
K_FAR_TARGETS = kern.FAR_TARGETS


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _pad(x, m: int = K_PAD):
    """x rounded up to a multiple of m (ints or int64 tensors)."""
    return (x + m - 1) // m * m


def _target_slots(n: int, per_thread: int, blocks: int) -> int:
    """Targets a launch sweeps for n targets: thread x of block g holds
    per_thread targets from (g * per_thread) * K_THREADS + x and sweeps
    all of them when the first lies below n (load_targets, `if (local[0]
    < n)`); the others are swept at the origin and not stored."""
    return per_thread * sum(min(K_THREADS, max(0, n - g * per_thread
                                               * K_THREADS))
                            for g in range(blocks))


def tile_slots(b: int) -> int:
    """Target slots of one tile of b in the table and near sweeps: grid
    (tiles, ceil(b / (R * kThreads))) with R = targets_per_thread(b)."""
    r = max(1, min(K_MAX_TARGETS, b // K_THREADS))
    return _target_slots(b, r, -(-b // (r * K_THREADS)))


def far_slots(n: int) -> int:
    """Target slots of the far sweep over n targets (far_blocks blocks)."""
    return _target_slots(n, K_FAR_TARGETS, kern.far_blocks(n))


def far_swept(n_live: int, s_cap: int) -> int:
    """Sources the far sweep sweeps for each target: its live count,
    clamped to [0, s_cap], in chunks of kFarChunk, each padded to kPad."""
    live = min(max(n_live, 0), s_cap)
    return sum(_pad(min(K_FAR_CHUNK, live - base))
               for base in range(0, live, K_FAR_CHUNK))


def near_tile_lanes(bands, n_src: int) -> torch.Tensor:
    """[T] int64: the lanes near_span stages into its ring for each tile,
    the set mask bits of its first min(win_cnt, w_cap) windows that lie
    below n_src (the kernel clears lanes past n_src)."""
    first = bands.win_first.to(torch.int64)                  # [T, W]
    t, w_cap = first.shape
    cnt = torch.clamp(bands.win_cnt.to(torch.int64), max=w_cap)
    word = torch.arange(4, device=first.device)[None, :, None]
    room = n_src - first[:, None, :] - 32 * word             # [T, 4, W]
    keep = torch.where(room >= 32, torch.full_like(room, 0xFFFFFFFF),
                       (1 << torch.clamp(room, 0, 31)) - 1)
    bits = bands.win_mask.to(torch.int64) & 0xFFFFFFFF & keep
    live_win = torch.arange(w_cap, device=first.device)[None, :] < cnt[:, None]
    return (popcount32(bits) * live_win[:, None, :]).sum(dim=(1, 2))


def work(cfg: SimConfig, ps, ss, bands, tables, n_src=None) -> Dict:
    """Per force kernel, the work of one call on these band structures:
    {"live": live pairs, "executed": pairs the CUDA kernel iterates,
    "bytes": inputs read once and outputs written once}; and for the near
    sweep also "live_lanes" and "executed_lanes".  n_src: the near sweep's
    source rows (default: the targets).

    Live pairs: far n_pad x n_supers; table tile x sum(near_cnt + row_cnt
    - near_cap); near tile x the set mask bits of each tile's first
    win_cnt windows (prof_nearwin.live_lanes).  Executed pairs follow the
    kernels' loops: the far sweep takes the live list (clamped to its
    capacity) in chunks of kFarChunk, each padded to a multiple of kPad;
    the table sweep a tile's live rows in batches of kThreads, the last
    padded to kPad; the near sweep compacts a tile's live lanes into a
    ring, sweeps it kThreads at a time and pads the rest to kPad.  So each
    run's padded length is _pad(its live length), times the target slots
    of the launch (far_slots, tile_slots)."""
    n, b = ps.shape[0], cfg.force_tile
    n_src = n if n_src is None else n_src
    t = n // b
    n_live = int(ss.n_supers)
    rows_cap = tables.tx.shape[1]
    near_cnt = bands.near_cnt.to(torch.int64)
    row_cnt = tables.row_cnt.to(torch.int64)
    live_rows = int((near_cnt + row_cnt - cfg.near_cap).sum())
    swept_rows = (torch.clamp(tables.near_cnt.to(torch.int64),
                              max=cfg.near_cap)
                  + torch.clamp(torch.clamp(row_cnt, max=rows_cap)
                                - cfg.near_cap, min=0))
    lanes = live_lanes(bands)
    swept_lanes = int(_pad(near_tile_lanes(bands, n_src)).sum())
    windows = int(bands.win_cnt.sum())
    slots = tile_slots(b)
    return {
        "far_sweep": {"live": n * n_live,
                      "executed": far_slots(n) * far_swept(
                          n_live, ss.gmass.shape[0]),
                      "bytes": 24 * n + 16 * n_live + 4},
        "table_sweep": {"live": b * live_rows,
                        "executed": slots * int(_pad(swept_rows).sum()),
                        "bytes": 24 * n + 16 * live_rows + 8 * t},
        "near_span": {"live": b * lanes, "executed": slots * swept_lanes,
                      "bytes": 24 * n + 16 * n_src + 20 * windows + 4 * t,
                      "live_lanes": lanes, "executed_lanes": swept_lanes},
    }


def kernel_calls(cfg: SimConfig, ps, ms, ss, bands, tables) -> Dict:
    """(kernel, plain) zero-argument callables for each of the three."""
    b = bands
    return {
        "far_sweep": (lambda: kern.far_sweep(ps, ss, cfg),
                      lambda: forces.far_sweep_torch(ps, ss, cfg)),
        "table_sweep": (lambda: kern.table_sweep(ps, tables, cfg),
                        lambda: forces.table_sweep_torch(ps, tables, cfg)),
        "near_span": (lambda: kern.near_span(ps, ps, ms, b.win_first,
                                             b.win_mask, b.win_cnt, cfg),
                      lambda: forces.near_correction_torch(
                          ps, ps, ms, b.win_first, b.win_mask, b.win_cnt,
                          cfg)),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="v5_bench", choices=sorted(PRESETS))
    ap.add_argument("--n", type=int, help="bodies (default: the preset's)")
    ap.add_argument("--frames", type=int, default=32,
                    help="steps of a timed run_scan call, rounded up to a "
                         "multiple of K")
    ap.add_argument("--k", type=int, help="rebuild_every (preset's)")
    ap.add_argument("--tile", type=int, help="force_tile (preset's)")
    ap.add_argument("--r", type=int, help="hold_farmid (preset's)")
    ap.add_argument("--span", type=int, choices=(0, 1),
                    help="farmid_span_rebuilds (preset's)")
    ap.add_argument("--caps", default="",
                    help="per-band caps, bench.py's syntax: "
                         "sup_cap:320,cmid_cap:768")
    ap.add_argument("--over", default="",
                    help="SimConfig overrides k=v,k=v")
    ap.add_argument("--phases", action="store_true",
                    help="print utils.profiling.phase_times")
    ap.add_argument("--drift-steps", type=int, default=1000)
    ap.add_argument("--skip-drift", action="store_true")
    ap.add_argument("--skip-selfcheck", action="store_true")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def make_config(args: argparse.Namespace, device: torch.device):
    """(cfg, frames): the preset with the flags applied (theta 0.5, the
    kernels on CUDA) and frames rounded up to a multiple of K, so no
    timed call ends in a short remainder cycle."""
    preset = PRESETS[args.preset]

    def pick(flag, field):
        return getattr(preset, field) if flag is None else flag

    k = pick(args.k, "rebuild_every")
    cfg = preset.replace(
        n=pick(args.n, "n"), theta=0.5, use_pallas=device.type == "cuda",
        rebuild_every=k, force_tile=pick(args.tile, "force_tile"),
        hold_farmid=pick(args.r, "hold_farmid"),
        farmid_span_rebuilds=bool(pick(args.span, "farmid_span_rebuilds")))
    cfg = cfg.replace(**common.parse_overrides(args.caps.replace(":", "=")))
    cfg = cfg.replace(**common.parse_overrides(args.over))
    frames = max(k, -(-args.frames // k) * k)
    return cfg, frames


def memory_check(cfg: SimConfig, device: torch.device) -> None:
    """The reuse runner holds two table generations across a rebuild:
    warn when they exceed the card's free memory."""
    if device.type != "cuda":
        log(f"band tables {cfg.table_bytes / 2**30:.3f} GiB a generation")
        return
    need = 2 * cfg.table_bytes
    free, total = torch.cuda.mem_get_info(device)
    log(f"band tables {cfg.table_bytes / 2**30:.3f} GiB a generation; "
        f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
    if need > free:
        log(f"WARNING: two table generations ({need / 2**30:.2f} GiB) "
            f"exceed the card's free memory; shrink the caps or raise "
            f"force_tile")


@contextlib.contextmanager
def far_counter(device: torch.device):
    """Counts far sweeps while the block runs: on CUDA the kernel's
    launches (ops/cuda/forces.LAUNCHES), on the CPU the calls of the
    plain far sweep.  Yields a zero-argument function returning the count
    so far."""
    if device.type == "cuda":
        start = kern.LAUNCHES["far_sweep"]
        yield lambda: kern.LAUNCHES["far_sweep"] - start
        return
    plain, calls = forces.far_sweep_torch, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    forces.far_sweep_torch = counted
    try:
        yield lambda: calls[0]
    finally:
        forces.far_sweep_torch = plain


def sustained(sim: Simulation, state, frames: int) -> Dict:
    """TIMED_CALLS run_scan(state, frames) calls after one untimed one,
    each from `state`: {"rates": steps/s of each, "refreshes": far+mid
    refreshes a call, "rebuilds": band builds a call (the adaptive
    runner counts its own), "launches": kernel launches over the timed
    calls}.  Every call does the same work (run_scan starts a fresh
    runner); a call whose refresh or rebuild count differs from the
    first's raises."""
    _sync(sim.run_scan(state, frames))
    kern.reset_launches()
    rates, counts = [], set()
    with far_counter(state.device) as far:
        for _ in range(TIMED_CALLS):
            f0, rb0 = far(), sim.n_rebuilds
            _sync(state)
            t0 = time.perf_counter()
            _sync(sim.run_scan(state, frames))
            rates.append(frames / (time.perf_counter() - t0))
            counts.add((far() - f0, sim.n_rebuilds - rb0))
    if len(counts) != 1:
        raise RuntimeError(f"timed calls did different work: (refreshes, "
                           f"rebuilds) {sorted(counts)}")
    (refreshes, rebuilds), = counts
    cfg = sim.cfg
    if cfg.rebuild_every <= 1:           # a full rebuild every step
        rebuilds = frames
    elif not cfg.adaptive_rebuild:       # one a K-step cycle
        rebuilds = -(-frames // cfg.rebuild_every)
    return {"rates": rates, "refreshes": refreshes, "rebuilds": rebuilds,
            "launches": dict(kern.LAUNCHES)}


def timed_structure(cfg: SimConfig, state):
    """(ps, cells, ss, bands, tables): the band structure the timed calls
    sweep first.  The adaptive runner's first rebuild of a call
    (tools.common.first_rebuild: skins for K steps); for a per-step
    rebuild (K <= 1) or fixed-K cycles the build without skins, which a
    cycle's skins outgrow."""
    if cfg.adaptive_rebuild and cfg.rebuild_every > 1:
        rebuild, args = common.first_rebuild(state, cfg)
        (pos, *_), (cells, ss, bands, tables, _), _ = rebuild(*args)
        return pos, cells, ss, bands, tables
    ps, ms, cs, *_ = common.sorted_padded(state, cfg)
    cells, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    return ps, cells, ss, bands, tables


def flop_fields(cfg: SimConfig, state, value: float, refreshes: int,
                frames: int) -> Dict:
    """gflops, gflops_useful, mfu, near_lane_occupancy and the overflow
    flags from the structure at the timed state: a step does the near
    sweep and, refreshes / frames of the time, far and table."""
    ps, cells, ss, bands, tables = timed_structure(cfg, state)
    w = work(cfg, ps, ss, bands, tables)
    share = refreshes / frames

    def per_step(kind):
        return FLOPS_PER_PAIR * (w["near_span"][kind] + share * (
            w["far_sweep"][kind] + w["table_sweep"][kind]))

    flops = per_step("executed")
    out = {
        "gflops": flops * value / 1e9,
        "gflops_useful": per_step("live") * value / 1e9,
        # the H100's peak says nothing of a CPU run's rate
        "mfu": (flops * value / PEAK_FP32 if state.device.type == "cuda"
                else None),
        "near_lane_occupancy": (w["near_span"]["live_lanes"]
                                / max(w["near_span"]["executed_lanes"], 1)),
    }
    flags = common.overflow_flags(cells, bands)
    out["overflow_bands"] = any(flags[k] for k in common.FLAGS[:5])
    out["overflow_cells"] = flags["cells"]
    out["overflow_g2_graceful"] = flags["g2"]
    out["overflow"] = out["overflow_bands"] or out["overflow_cells"]
    log(f"pairs a call (live / executed): " + ", ".join(
        f"{k} {v['live']:.4e} / {v['executed']:.4e}" for k, v in w.items())
        + f"; far+mid refreshes {refreshes} in {frames} steps")

    def mean(x):
        return float(x.to(torch.float32).mean())

    log(f"bands: ss={mean(bands.ss_cnt):.1f} sup={mean(bands.sup_cnt):.1f} "
        f"mid={mean(bands.mid_cnt):.1f} cmid={mean(bands.cmid_cnt):.1f} "
        f"near={mean(bands.near_cnt):.1f} wins={mean(bands.win_cnt):.1f} "
        f"n_cells={int(cells.n_cells)} overflow=bands:"
        f"{out['overflow_bands']}/cells:{out['overflow_cells']}")
    return out


def drift_fields(sim: Simulation, ic, steps: int, frames: int) -> Dict:
    """metrics.drift_protocol from the initial conditions in chunks of
    `frames` (the kilostep gate's protocol); raises past DRIFT_LIMIT."""
    dp = metrics.drift_protocol(sim, ic, n_steps=steps, chunk=frames)
    n = dp["drift_steps"]
    log(f"E0={dp['e0']:.9e} E1={dp['e1']:.9e} drift_{n}={dp['drift']:.6e} "
        f"(criterion {DRIFT_CRITERION:.1%}: "
        f"{'pass' if dp['drift'] < DRIFT_CRITERION else 'FAIL'}; limit "
        f"{DRIFT_LIMIT:.0%})")
    log(f"whole-run average over {n} steps: {dp['avg_steps_per_sec']:.3f} "
        f"steps/s; hot-state chunk (after {n - frames} steps): "
        f"{dp['hot_steps_per_sec']:.3f} steps/s")
    if not dp["drift"] < DRIFT_LIMIT:
        raise RuntimeError(f"energy drift {dp['drift']} over {n} steps is "
                           f"not below {DRIFT_LIMIT}")
    return {"drift": dp["drift"], "drift_steps": n,
            "drift_ok": dp["drift"] < DRIFT_CRITERION,
            "value_hot": dp["hot_steps_per_sec"],
            "value_avg_1k": dp["avg_steps_per_sec"]}


def selfcheck(cfg: SimConfig, device: torch.device) -> Dict:
    """Each hand kernel against its plain version on the card at n =
    50,000, at the bench's own config and at force_tile 128 with
    near_cap=60: the field is bench.py's max |kernel - plain| / (|plain|
    + 1e-6); the bound (BOUNDS) holds on |kernel - plain| over the total
    plain acceleration, the measure it is set for."""
    out = {}
    for suffix, geo in (("", cfg.replace(n=SELFCHECK_N)),
                        ("_t128", cfg.replace(n=SELFCHECK_N, force_tile=128,
                                              near_cap=60))):
        state = make_initial_state(geo, device=device)
        ps, ms, cs, *_ = common.sorted_padded(state, geo)
        _, ss, bands, tables = forces.build_bands(ps, ms, cs, geo)
        outs = {k: (kfn(), pfn()) for k, (kfn, pfn) in kernel_calls(
            geo, ps, ms, ss, bands, tables).items()}
        total = sum(p for _, p in outs.values()).norm(dim=1) + 1e-6
        for k, (ko, po) in outs.items():
            if not torch.isfinite(ko).all():
                raise RuntimeError(f"selfcheck{suffix}: {k} is not finite")
            diff = (ko - po).norm(dim=1)
            own = float((diff / (po.norm(dim=1) + 1e-6)).max())
            of_total = float((diff / total).max())
            log(f"selfcheck tile {geo.force_tile} near_cap {geo.near_cap}: "
                f"{k} {own:.3e} of its own output, {of_total:.3e} of the "
                f"total (bound {BOUNDS[k]:.0e})")
            if not of_total <= BOUNDS[k]:
                raise RuntimeError(f"selfcheck{suffix}: {k} error "
                                   f"{of_total} > {BOUNDS[k]}")
            out[f"selfcheck_{SELFCHECK_NAMES[k]}{suffix}"] = own
    return out


def run(args: argparse.Namespace) -> Dict:
    """Every phase of the bench; returns its JSON line's fields."""
    dev = common.device_of(args.device)
    cfg, frames = make_config(args, dev)
    on_cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    log(f"n={cfg.n} theta={cfg.theta} K={cfg.rebuild_every} "
        f"R={cfg.hold_farmid} tile={cfg.force_tile} frames={frames} "
        f"device={kind}")
    memory_check(cfg, dev)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sim = Simulation(cfg, device=dev)
    ic = sim.init_state()
    _sync(ic)
    t0 = time.perf_counter()
    state = sim.step(ic)
    _sync(state)
    log(f"first step (kernel load, overflow probe): "
        f"{time.perf_counter() - t0:.1f} s")

    # dispatched per-step rate, one host sync a step (the reference's
    # cudaEventSynchronize loop); for the record only
    times = []
    for _ in range(min(frames, 12)):
        t0 = time.perf_counter()
        state = sim.step(state)
        _sync(state)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"dispatched step: {med * 1e3:.2f} ms ({1 / med:.3f} steps/s)")

    sus = sustained(sim, state, frames)
    rates = sus["rates"]
    value = statistics.median(rates)
    log(f"sustained: {frames}-step run_scan calls at " + ", ".join(
        f"{r:.3f}" for r in rates) + f" steps/s; median {value:.3f}; "
        f"{sus['rebuilds']} rebuilds and {sus['refreshes']} far+mid "
        f"refreshes a call" + (f"; launches {sus['launches']}"
                               if on_cuda else ""))
    if args.phases:
        log(f"phases: {json.dumps(phase_times(state, cfg, iters=5))}")

    # No published reference numbers exist (BASELINE.md).  The 10 steps/s
    # bar is bench.py's phase-by-phase cost model of the CUDA reference's
    # nbody_v5_bench.cu simulationStep (:255-283) at N=1M on sm_75-class
    # hardware (~1.4 GHz, ~448 GB/s), kept generous to the reference:
    # a one-thread bounding box (4-10 ms), Morton encode and thrust sort
    # (1-2 ms), a 152 MB node memset (0.4 ms), 977 sequential
    # 1024-thread insert launches (3.5-8 ms), a contended per-ancestor
    # atomicAdd COM (10-30 ms), a per-body stack DFS force pass gathering
    # from the node pool (30-80 ms) and integration (0.3 ms): ~50-130 ms,
    # ~100 ms a step at its centre.  It is not a TPU number and not a
    # measurement.
    baseline_steps_per_sec = 10.0
    n = cfg.n
    out = {
        "metric": ("bh_steps_per_sec_1M_theta0.5" if n == 1_000_000
                   else f"bh_steps_per_sec_{n}_theta0.5"),
        "value": value,
        "unit": "steps/sec",
        "vs_baseline": value / baseline_steps_per_sec,
        "value_spread": (max(rates) - min(rates)) / value,
        "device": kind,
        "refreshes": sus["refreshes"],
        "rebuilds": sus["rebuilds"],
    }
    if on_cuda:
        out["launches"] = sus["launches"]
    out.update(flop_fields(cfg, state, value, sus["refreshes"], frames))
    if args.skip_drift:
        log("drift skipped (--skip-drift)")
    else:
        out.update(drift_fields(sim, ic, args.drift_steps, frames))
    if args.skip_selfcheck:
        log("selfcheck skipped (--skip-selfcheck)")
    elif not on_cuda:
        log("selfcheck: no kernel runs on the CPU; the selfcheck_* fields "
            "are left out")
    else:
        out.update(selfcheck(cfg, dev))
    log(f"KE: {float(metrics.kinetic_energy(state)):.6e}")
    if on_cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        log(f"peak memory {out['peak_memory_bytes'] / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated)")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    # stdout carries the one JSON line alone
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
