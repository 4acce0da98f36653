#!/usr/bin/env python3
"""Smoke run of nbody_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA force kernels from nbody_tpu_torch/csrc, holds each
kernel against its plain PyTorch version at two 50k-body geometries and
at the shapes of the main path, then drives the main path: the v5_bench
preset (N = 1,000,000, force_tile 512, no_ss) through
``Simulation(cfg).step``, one warm-up step and three timed steps, with a
per-phase breakdown, live band counts, launch counts and an accuracy
check against a direct sum.  Every failing check raises (non-zero exit).
The line before the last is one JSON object per kernel
({"kernels": [...]}, times in ms on this card), preceded by the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.models.simulation import Simulation, sort_by_morton
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.ops import bbox, forces, integrate
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.cuda import build, forces as kern
from nbody_tpu_torch.utils import metrics

# H100 SXM published peaks: FP32 outside the tensor cores and HBM
# bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_PAIR = 20        # 3 sub, 3 mul + 3 add (d2 + soft), sqrt,
                           # division, 3 mul (m * inv^3), 3 mul + 3 add
                           # (the terms and their sums), one op each
# max over targets of |kernel - plain| / (|total plain acceleration| + 1e-6)
BOUNDS = {"far_sweep": 1e-4, "table_sweep": 5e-4, "near_span": 1e-4}
REPLACES = {
    "far_sweep": "nbody_tpu/ops/pallas/forces.py:125",
    "table_sweep": "nbody_tpu/ops/pallas/forces.py:214",
    "near_span": "nbody_tpu/ops/pallas/forces.py:408",
}
SOURCE = "nbody_tpu_torch/csrc/forces.cu"
DEVICE = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up."""
    fn()
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def sorted_inputs(cfg, state):
    """(pos, mass, codes) Morton-sorted and tile-padded, and the perm."""
    codes, perm, _, _ = sort_by_morton(state.pos, cfg)
    return forces.pad_sorted(state.pos[perm], state.mass[perm], codes,
                             cfg.force_tile) + (perm,)


def kernel_calls(cfg, ps, ms, ss, bands, tables):
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


def compare(calls):
    """Per kernel (max relative error against the plain total, max
    absolute error), each kernel against its plain version."""
    outs = {k: (kfn(), pfn()) for k, (kfn, pfn) in calls.items()}
    sync()
    total = sum(p for _, p in outs.values()).norm(dim=1) + 1e-6
    res = {}
    for k, (ko, po) in outs.items():
        if not torch.isfinite(ko).all():
            raise RuntimeError(f"{k}: kernel output is not finite")
        diff = (ko - po).norm(dim=1)
        res[k] = (float((diff / total).max()), float((ko - po).abs().max()))
    return res


def popcount32(x: torch.Tensor) -> torch.Tensor:
    v = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(v)
    for k in range(32):
        n += (v >> k) & 1
    return n


def bounds_ms(cfg, ps, ss, bands, tables):
    """Least time for each kernel's work on this run's data: the larger of
    FP32 operations over the FP32 peak and bytes (inputs read once,
    outputs written once) over the memory rate; (ms, bound_by)."""
    n, b = ps.shape[0], cfg.force_tile
    t = n // b
    n_live = int(ss.n_supers)
    live_rows = (bands.near_cnt.to(torch.int64)
                 + tables.row_cnt.to(torch.int64) - cfg.near_cap)
    rows = int(live_rows.sum())
    wc = bands.win_cnt.to(torch.int64)
    lane_ok = torch.arange(bands.win_first.shape[1], device=ps.device) < wc[:, None]
    lanes = int((popcount32(bands.win_mask) * lane_ok[:, None, :]).sum())
    work = {
        "far_sweep": (n * n_live, 24 * n + 16 * n_live + 4),
        "table_sweep": (b * rows, 24 * n + 16 * rows + 8 * t),
        "near_span": (b * lanes, 24 * n + 16 * n + 20 * int(wc.sum()) + 4 * t),
    }
    out = {}
    for k, (pairs, nbytes) in work.items():
        t_ops = FLOPS_PER_PAIR * pairs / PEAK_FP32
        t_mem = nbytes / PEAK_BYTES
        out[k] = (1e3 * max(t_ops, t_mem),
                  "operations" if t_ops >= t_mem else "bytes")
    return out


def check_geometry(label, cfg):
    state = make_initial_state(cfg, device=DEVICE)
    ps, ms, cs, _ = sorted_inputs(cfg, state)
    _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    calls = kernel_calls(cfg, ps, ms, ss, bands, tables)
    errs = compare(calls)
    for k, (kfn, pfn) in calls.items():
        rel, _ = errs[k]
        k_ms, p_ms = event_ms(kfn, 10), event_ms(pfn, 2)
        log(f"[kernels {label}] {k}: rel_err {rel:.3e} (bound "
            f"{BOUNDS[k]:.0e})  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms")
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} at {label}: error {rel} > {BOUNDS[k]}")
    return {k: v[0] for k, v in errs.items()}


def phase_breakdown(cfg, state):
    """One step phase by phase with a device sync around each phase;
    returns (per-phase ms, the sorted inputs and band structures)."""
    ms_by = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms_by[name] = ms_by.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    ps, ms, cs, perm = timed("sort", lambda: sorted_inputs(cfg, state))
    box_lo, box_size = bbox.bounding_cube(ps)
    cells = timed("cells", lambda: build_source_cells(
        cs, ps, ms, cfg.force_tile, cfg.g, cfg.cell_capacity, box_lo,
        box_size, g2_factor=cfg.g2_cap_factor, bits=cfg.morton_bits))

    def classify():
        supers = forces.make_supers(cells)
        ss = forces.make_ss(supers, cfg)
        subs = forces.target_subspheres(ps, cfg.force_tile, codes=cs,
                                        bits=cfg.morton_bits)
        return supers, ss, forces.cell_band_lists(subs, ss, supers, cells, cfg)

    supers, ss, bands = timed("classify", classify)
    tables = timed("tables", lambda: forces.build_cell_tables(cells, supers,
                                                              ss, bands))
    acc = timed("far", lambda: kern.far_sweep(ps, ss, cfg))
    acc = acc + timed("table", lambda: kern.table_sweep(ps, tables, cfg))
    acc = acc + timed("near", lambda: kern.near_span(
        ps, ps, ms, bands.win_first, bands.win_mask, bands.win_cnt, cfg))

    def unsort_and_integrate():
        out = torch.empty_like(state.pos)
        out[perm] = acc[:state.n]
        return integrate.integrate(state, out, cfg)

    timed("integrate", unsort_and_integrate)
    return ms_by, (ps, ms, cells, ss, bands, tables)


def profile_step(sim, state, top=12):
    """torch.profiler over one step: wall time, the device's busy share,
    the device kernel count, and the ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(state)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    kernels = sum(e.count for e in device)
    log(f"[profile] one step: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{kernels} device kernels")
    aten = [e for e in events if e.key.startswith("aten::")]
    for label, attr in (("device", "device_time_total"),
                        ("host (self)", "self_cpu_time_total")):
        ops = sorted(aten, key=lambda e: getattr(e, attr), reverse=True)[:top]
        log(f"[profile] aten ops by {label} time (ms, calls): " + ", ".join(
            f"{e.key[6:]} {getattr(e, attr) / 1e3:.1f} ({e.count})"
            for e in ops))


def direct_check(prev, acc, cfg, n_targets=4096, seed=7):
    """Median relative error of `acc` at n_targets random bodies against a
    float64 direct sum over all sources (the bound of
    tests/test_forces.py's grouped-vs-direct test: 2%)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randperm(prev.n, generator=gen, device=DEVICE)[:n_targets]
    tgt = prev.pos[idx].double()
    src, m = prev.pos.double(), prev.mass.double()
    ref = torch.zeros_like(tgt)
    for j in range(0, prev.n, 16384):
        ref += forces._panel_accel(tgt, src[j:j + 16384], m[j:j + 16384],
                                   cfg.g, forces.soft_term(cfg))
    err = (acc[idx].double() - ref).norm(dim=1) / ref.norm(dim=1)
    return float(err.median()), float(err.max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.load()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    base = PRESETS["v5_bench"]
    geo_err = {
        "t512": check_geometry("n=50k t512", base.replace(n=50_000)),
        "t128": check_geometry("n=50k t128 near_cap=60", base.replace(
            n=50_000, force_tile=128, near_cap=60)),
    }

    # --- main path: v5_bench, N = 1M, through Simulation.step ------------
    cfg = base
    sim = Simulation(cfg, device=DEVICE)
    state = sim.init_state()
    t0 = time.perf_counter()
    state = sim.step(state)
    sync()
    log(f"[main] warm-up step (with the one-time overflow probe) "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    kern.reset_launches()
    step_ms = []
    for _ in range(3):
        prev = state
        t0 = time.perf_counter()
        state = sim.step(state)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(kern.LAUNCHES)
    log(f"[main] v5_bench n={cfg.n}: steps {['%.1f' % s for s in step_ms]} "
        f"ms, median {sorted(step_ms)[1]:.1f} ms/step; launches {launches}")
    for k, v in launches.items():
        if v == 0:
            raise RuntimeError(f"main path never launched {k}")
    for name, x in zip(("pos", "vel", "acc"), (state.pos, state.vel,
                                                state.acc)):
        if not torch.isfinite(x).all():
            raise RuntimeError(f"non-finite {name} after the main path")
    med, worst = direct_check(prev, state.acc, cfg)
    log(f"[main] acceleration vs float64 direct sum at 4096 bodies: median "
        f"rel err {med:.3e} (bound 2e-2), max {worst:.3e}")
    if not med < 0.02:
        raise RuntimeError(f"median force error {med} >= 2%")
    log(f"[main] KE {float(metrics.kinetic_energy(state)):.6e}")

    profile_step(sim, state)
    phases, (ps, ms, cells, ss, bands, tables) = phase_breakdown(cfg, state)
    log("[main] phases (ms): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
    t = bands.win_cnt.shape[0]
    means = {k: float(getattr(bands, f"{k}_cnt").float().mean())
             for k in ("ss", "sup", "mid", "cmid", "near", "win")}
    log(f"[main] n_cells {int(cells.n_cells)} / {cfg.cell_capacity}, tiles "
        f"{t}, n_ss live {int(ss.n_supers)}; mean per tile " + ", ".join(
            f"{k} {v:.1f}" for k, v in means.items()))
    flags = {k: bool(getattr(bands, f"{k}_overflow"))
             for k in ("ss", "sup", "mid", "cmid", "near")}
    flags.update(cells=bool(cells.overflow), g2=bool(cells.overflow_g2))
    log(f"[main] overflow {flags}")

    calls = kernel_calls(cfg, ps, ms, ss, bands, tables)
    errs = compare(calls)
    bnd = bounds_ms(cfg, ps, ss, bands, tables)
    rows = []
    for k, (kfn, pfn) in calls.items():
        rel, abs_err = errs[k]
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} at the main path: error {rel} > "
                               f"{BOUNDS[k]}")
        k_ms, p_ms = event_ms(kfn, 20), event_ms(pfn, 2)
        rows.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[k][0], "bound_by": bnd[k][1], "library_ms": None,
            "rel_err_main": rel, "rel_err_t512": geo_err["t512"][k],
            "rel_err_t128": geo_err["t128"][k],
            "launches_per_step": launches[k] / len(step_ms),
        })
        log(f"[kernels main] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bnd[k][0]:.3f} ms ({bnd[k][1]}), rel_err {rel:.3e}")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
