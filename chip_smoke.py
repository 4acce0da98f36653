#!/usr/bin/env python3
"""Smoke run of nbody_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from nbody_tpu_torch/csrc (one nvcc per source),
holds each force kernel against its plain PyTorch version at two 50k-body
geometries and at the shapes of the main path, then drives the paths of
the v5_bench preset (N = 1,000,000, force_tile 512, no_ss) with the
launch counts zeroed before each and read after it:
  [main]   the per-step rebuild, ``Simulation(cfg).step``: one warm-up
           and three timed steps, a profile, a per-phase breakdown, live
           band counts and an accuracy check against a direct sum;
  [runner] the adaptive band-reuse runner, ``Simulation.run_scan``, under
           ``metrics.drift_protocol`` from the initial conditions (1024
           steps in chunks of 32): energy drift (< 1% enforced, the 0.2%
           criterion reported), steps/s, rebuilds, launches, the force
           error after the run, each force kernel against its plain
           version on the runner's own skinned bands at the evolved
           state with its time and bound there, near_span's window-lane
           and live pairs, the tile orders' time, the host syncs of a
           32-step run and of inner steps (at most one per rebuild, none
           in an inner step), and
           profiles of one 32-step chunk and of one inner step;
  [probe]  ``nbody_tpu_torch.tools.prof_mxu`` at its own shape, the panel
           sweep kernel in its three variants, each held against its plain
           version.
Every failing check raises (non-zero exit).  The line before the last is
one JSON object per kernel ({"kernels": [...]}, times in ms on this
card), preceded by the card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import torch

from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.models import simulation
from nbody_tpu_torch.models.simulation import Simulation, sort_by_morton
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.ops import bbox, forces, integrate, panel
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.cuda import build, forces as kern
from nbody_tpu_torch.ops.cuda import panel as panel_kern
from nbody_tpu_torch.tools import prof_mxu
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
SOURCE = {
    "far_sweep": "nbody_tpu_torch/csrc/forces.cu",
    "table_sweep": "nbody_tpu_torch/csrc/tile_sweeps.cu",
    "near_span": "nbody_tpu_torch/csrc/tile_sweeps.cu",
}
PANEL_SOURCE = "nbody_tpu_torch/csrc/panel.cu"
PANEL_REPLACES = "tools/_prof_mxu.py:79"
# FP32 operations per pair of each panel variant: 3 sub, d2 (3 mul, 2
# add), + soft, rsqrt, inv^3 (2 mul), * m, then vpu: 3 mul + 3 add;
# mxu/mxu_c: 1 add (sum w) + 3 mul + 3 add (sum w q)
PANEL_OPS = {"vpu": 19, "mxu": 20, "mxu_c": 20}
# max over targets of |kernel - plain| / (the variant's term scale,
# panel.term_scale): float32 sums in two orders differ by a few ulps
# of the sum of |terms|
PANEL_BOUND = 1e-5
DRIFT_LIMIT = 0.01         # enforced: a broken schedule drifts 6.6-13%
DRIFT_CRITERION = 0.002    # the BASELINE.json criterion, reported
RUNNER_STEPS = 1024
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
    lanes = live_lanes(bands)
    windows = int(bands.win_cnt.sum())
    work = {
        "far_sweep": (n * n_live, 24 * n + 16 * n_live + 4),
        "table_sweep": (b * rows, 24 * n + 16 * rows + 8 * t),
        "near_span": (b * lanes, 24 * n + 16 * n + 20 * windows + 4 * t),
    }
    out = {}
    for k, (pairs, nbytes) in work.items():
        t_ops = FLOPS_PER_PAIR * pairs / PEAK_FP32
        t_mem = nbytes / PEAK_BYTES
        out[k] = (1e3 * max(t_ops, t_mem),
                  "operations" if t_ops >= t_mem else "bytes")
    return out


def live_lanes(bands):
    """Set mask bits over each tile's first win_cnt windows, summed."""
    wc = bands.win_cnt.to(torch.int64)
    lane_ok = torch.arange(bands.win_first.shape[1],
                           device=wc.device) < wc[:, None]
    return int((popcount32(bands.win_mask) * lane_ok[:, None, :]).sum())


def near_pairs_report(label, cfg, bands):
    """near_span's pairs: all 128 lanes of every live window against the
    live lanes alone (what the kernel sweeps and the bound counts)."""
    windows = int(bands.win_cnt.sum())
    lanes = live_lanes(bands)
    b = cfg.force_tile
    log(f"[{label}] near_span pairs: window lanes {windows * 128 * b:.4e} "
        f"({windows} windows), live {lanes * b:.4e}; live share "
        f"{lanes / max(windows * 128, 1):.4f} ({lanes / max(windows, 1):.1f} "
        f"of 128 lanes per window)")


def tile_order_report(label, bands, tables):
    """Device time of the heaviest-first tile orders, which the two
    per-tile wrappers compute on every launch (inside their times)."""
    work = {"table_sweep": tables.near_cnt + tables.row_cnt,
            "near_span": bands.win_cnt}
    log(f"[{label}] heaviest-first tile order, inside the kernel times: "
        + ", ".join(f"{k} {event_ms(lambda: kern.heavy_first(w), 10):.3f} ms"
                    for k, w in work.items()))


def skinned_bands(cfg, state):
    """The runner's rebuild at `state` with envelopes for rebuild_every
    steps: (pos, mass, cells, ss, bands, tables, s_valid, k_next)."""
    pos, vel, mass, acc, orig = simulation._pad_cycle_state(state,
                                                           cfg.force_tile)
    k_env = torch.full((), cfg.rebuild_every, device=DEVICE)
    (pos, _, mass, _, _, _), (cells, ss, bands, tables, _), (
        s_valid, k_next) = simulation._adaptive_rebuild_fn(cfg)(
            pos, vel, mass, acc, orig, k_env)
    return pos, mass, cells, ss, bands, tables, s_valid, k_next


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


def profile_spans(spans, top=6):
    """One torch.profiler profile over the labelled callables of `spans`,
    each run in its own record_function range and synchronized.  Per
    span: wall time, device busy time and share and kernel count, read
    from the trace's kernel events launched inside the span (all of them:
    the ctypes-launched kernels have no aten op), and the kernels with
    the most device time; then the profile's aten ops with the most host
    time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    walls = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # warm-up: a short first span has come back without its kernels
        x = torch.zeros(1, device=DEVICE)
        for _ in range(200):
            x += 1
        sync()
        time.sleep(0.2)
        for label, fn in spans.items():
            t0 = time.perf_counter()
            with record_function(label):
                fn()
                sync()
            walls[label] = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # a kernel belongs to the span whose host range holds its launch (the
    # device clock's timestamps may be offset from the host's)
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime"
                   and "correlation" in e.get("args", {})}
    for label in spans:
        rng = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == label][0]
        lo, hi = rng["ts"], rng["ts"] + rng["dur"]
        mine = [e for e in kernels if lo <= launched_at.get(
            e.get("args", {}).get("correlation"), e["ts"]) <= hi]
        busy_ms = sum(e["dur"] for e in mine) / 1e3
        by_name = {}
        for e in mine:
            name = e["name"].replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split(" ")[-1][-40:]
            by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
        heavy = sorted(by_name.items(), key=lambda kv: kv[1],
                       reverse=True)[:top]
        log(f"[profile: {label}] wall {walls[label]:.1f} ms, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / walls[label]:.1f}%), "
            f"{len(mine)} device kernels; by device time (ms): " + ", ".join(
                f"{k} {v:.2f}" for k, v in heavy))
    aten = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    ops = sorted(aten, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:top]
    log(f"[profile] aten ops by host (self) time (ms, calls): " + ", ".join(
        f"{e.key[6:]} {e.self_cpu_time_total / 1e3:.1f} ({e.count})"
        for e in ops))


def band_report(label, cfg, cells, ss, bands):
    """Live band demand per tile and the overflow flags."""
    t = bands.win_cnt.shape[0]
    means = {k: float(getattr(bands, f"{k}_cnt").float().mean())
             for k in ("ss", "sup", "mid", "cmid", "near", "win")}
    log(f"[{label}] n_cells {int(cells.n_cells)} / {cfg.cell_capacity}, "
        f"tiles {t}, n_ss live {int(ss.n_supers)}; mean per tile " +
        ", ".join(f"{k} {v:.1f}" for k, v in means.items()))
    flags = {k: bool(getattr(bands, f"{k}_overflow"))
             for k in ("ss", "sup", "mid", "cmid", "near")}
    flags.update(cells=bool(cells.overflow), g2=bool(cells.overflow_g2))
    log(f"[{label}] overflow {flags}")


def direct_check(prev, acc, cfg, n_targets=4096, seed=7):
    """Median and maximum relative error of `acc` at n_targets random
    bodies against a float64 direct sum over all sources (the bound of
    tests/test_forces.py's grouped-vs-direct test: 2% on the median)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randperm(prev.n, generator=gen, device=DEVICE)[:n_targets]
    tgt = prev.pos[idx].double()
    src, m = prev.pos.double(), prev.mass.double()
    ref = torch.zeros_like(tgt)
    for j in range(0, prev.n, 16384):
        ref += forces._panel_accel(tgt, src[j:j + 16384], m[j:j + 16384],
                                   cfg.g, forces.soft_term(cfg))
    ref_norm = ref.norm(dim=1)
    err = (acc[idx].double() - ref).norm(dim=1) / ref_norm
    worst = int(err.argmax())
    log(f"[direct check] worst body: |ref| {float(ref_norm[worst]):.3e} "
        f"against a median |ref| of {float(ref_norm.median()):.3e}")
    return float(err.median()), float(err.max())


def count_syncs(fn):
    """(fn(), the number of synchronizing CUDA operations PyTorch made
    while it ran), read from CUDA sync debug mode's warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def check_finite(label, state):
    for name, x in zip(("pos", "vel", "acc"), (state.pos, state.vel,
                                                state.acc)):
        if not torch.isfinite(x).all():
            raise RuntimeError(f"non-finite {name} after the {label} path")


def runner_phase(cfg, steps, chunk=32):
    """The adaptive runner under drift_protocol from the initial
    conditions; returns its launch counts and, per force kernel on the
    runner's skinned bands at the evolved state, its (relative, absolute)
    error against the plain version and its (time, bound) in ms."""
    sim = Simulation(cfg, device=DEVICE)
    ic = sim.init_state()
    sync()
    kern.reset_launches()
    res = metrics.drift_protocol(sim, ic, steps, chunk=chunk)
    launches = dict(kern.LAUNCHES)
    rebuilds = sim.n_rebuilds
    taken, state = res["drift_steps"], res["state"]
    log(f"[runner] v5_bench n={cfg.n}: {taken} steps in chunks of {chunk}, "
        f"{res['seconds']:.1f} s; avg {res['avg_steps_per_sec']:.3f} "
        f"steps/s, hot (last chunk) {res['hot_steps_per_sec']:.3f} steps/s")
    log(f"[runner] rebuilds {rebuilds} ({taken / rebuilds:.2f} steps per "
        f"rebuild), far+mid refreshes {launches['far_sweep']}; launches "
        f"{launches}")
    verdict = "pass" if res["drift"] < DRIFT_CRITERION else "FAIL"
    log(f"[runner] energy drift {res['drift']:.6e} over {taken} steps "
        f"(E0 {res['e0']:.9e}, E1 {res['e1']:.9e}); 0.2% criterion: "
        f"{verdict} (not enforced); limit {DRIFT_LIMIT:.0%}")
    if launches["near_span"] != taken:
        raise RuntimeError(f"near launches {launches['near_span']} != "
                           f"{taken} steps")
    if not 1 <= launches["far_sweep"] <= taken:
        raise RuntimeError(f"far launches {launches['far_sweep']} outside "
                           f"[1, {taken}]")
    if launches["table_sweep"] != launches["far_sweep"]:
        raise RuntimeError("every far+mid refresh launches far and table")
    check_finite("runner", state)
    if not res["drift"] < DRIFT_LIMIT:
        raise RuntimeError(f"energy drift {res['drift']} >= {DRIFT_LIMIT}")
    # the force the runner computes at the evolved state: one more step
    # (a rebuild and a fresh far+mid) against a float64 direct sum
    nxt = sim.run_scan(state, 1)
    med, worst = direct_check(state, nxt.acc, cfg)
    log(f"[runner] acceleration after the run vs float64 direct sum at 4096 "
        f"bodies: median rel err {med:.3e} (bound 2e-2), max {worst:.3e}")
    if not med < 0.02:
        raise RuntimeError(f"median force error {med} >= 2% after the run")
    # where the outliers come from: the per-step rebuild (no skins) at the
    # same state, and the demand and flags of the runner's first rebuild
    # of a run_scan call (envelopes sized for K steps)
    med1, worst1 = direct_check(state, sim.step(state).acc, cfg)
    log(f"[runner] per-step rebuild at the evolved state: median rel err "
        f"{med1:.3e}, max {worst1:.3e}")
    ps, ms, cs, _ = sorted_inputs(cfg, state)
    cells, ss, bands, _ = forces.build_bands(ps, ms, cs, cfg)
    band_report("runner, evolved state, no skins", cfg, cells, ss, bands)
    pos, mass, cells, ss, bands, tables, s_valid, k_next = skinned_bands(
        cfg, state)
    band_report(f"runner, evolved state, {cfg.rebuild_every}-step skins", cfg,
                cells, ss, bands)
    log(f"[runner] that rebuild: s_valid {int(s_valid)}, k_next "
        f"{int(k_next)}")
    near_pairs_report("kernels runner", cfg, bands)
    calls = kernel_calls(cfg, pos, mass, ss, bands, tables)
    errs = compare(calls)
    bnd = bounds_ms(cfg, pos, ss, bands, tables)
    timing = {}
    for k, (rel, abs_err) in errs.items():
        timing[k] = (event_ms(calls[k][0], 10), bnd[k][0])
        log(f"[kernels runner] {k}: rel_err {rel:.3e} (bound "
            f"{BOUNDS[k]:.0e}), max abs err {abs_err:.3e}; kernel "
            f"{timing[k][0]:.3f} ms, bound {bnd[k][0]:.3f} ms ({bnd[k][1]}, "
            f"{100 * bnd[k][0] / timing[k][0]:.1f}% of it reached)")
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} on the runner's bands: error {rel} > "
                               f"{BOUNDS[k]}")
    tile_order_report("kernels runner", bands, tables)
    check_syncs(sim, ic, nxt, chunk)
    stepper = sim.make_stepper(nxt)
    profile_spans({
        "one inner step (with a far+mid refresh)": lambda: stepper.advance(1),
        f"one run_scan chunk of {chunk} steps": lambda: sim.run_scan(nxt,
                                                                     chunk),
    })
    return launches, errs, timing


def check_syncs(sim, ic, state, chunk):
    """Host syncs: at most one per rebuild over a run_scan chunk from
    `state`, none in an inner step with a far+mid refresh, and none in an
    inner refresh_moments refresh (a non-span hold of 1 from the IC,
    where the horizon is long)."""
    _, n = count_syncs(lambda: torch.ones(1, device=DEVICE).item())
    if n != 1:
        raise RuntimeError(f"sync debug mode counted {n} syncs for one .item()")
    rb0 = sim.n_rebuilds
    _, n = count_syncs(lambda: sim.run_scan(state, chunk))
    rebuilds = sim.n_rebuilds - rb0
    log(f"[runner] host syncs over one {chunk}-step run_scan: {n} for "
        f"{rebuilds} rebuilds")
    if n > rebuilds:
        raise RuntimeError(f"{n} host syncs for {rebuilds} rebuilds")
    rm = sim.cfg.replace(refresh_moments=True, farmid_span_rebuilds=False,
                         hold_farmid=1)
    # (simulation, state, steps before the counted one): the first step
    # after a rebuild refreshes far+mid; with a hold of 1 the second
    # refreshes through refresh_farmid
    checks = {
        "inner step with a far+mid refresh": (sim, state, 0),
        "inner refresh_moments refresh": (Simulation(rm, device=DEVICE), ic,
                                          1),
    }
    for label, (s, st, before) in checks.items():
        stepper = s.make_stepper(st)           # rebuilds
        stepper.advance(before)
        rb0 = stepper.n_rebuilds
        _, n = count_syncs(lambda: stepper.advance(1))
        log(f"[runner] host syncs in one {label}: {n}")
        if n or stepper.n_rebuilds != rb0:
            raise RuntimeError(f"{label}: {n} host syncs, "
                               f"{stepper.n_rebuilds - rb0} rebuilds")


def probe_phase():
    """nbody_tpu_torch.tools.prof_mxu at its own shape; each variant held
    against its plain version.  Returns the kernel JSON rows."""
    panel_kern.reset_launches()
    res = prof_mxu.run(device=DEVICE, log=lambda m: log(f"[probe] {m}"))
    launches = dict(panel_kern.LAUNCHES)
    inputs = res["inputs"]
    t, g = inputs[0].shape[0], inputs[1].shape[0]
    n = t * panel.B
    rows = []
    for name in panel.VARIANTS:
        key = f"panel_{name}"
        if launches[key] == 0:
            raise RuntimeError(f"the probe never launched {key}")

        def plain(name=name):
            return panel.sweep(panel.PANELS[name], *inputs)

        p_out = plain()
        scale = panel.term_scale(name, *inputs)
        k_out = res["out"][name]
        if not torch.isfinite(k_out).all():
            raise RuntimeError(f"{key}: kernel output is not finite")
        diff = k_out - p_out
        rel = float((diff.norm(dim=-1) / scale).max())
        abs_err = float(diff.abs().max())
        p_ms = event_ms(plain, 1)
        # operations: the pairs', plus mxu_c's centring (3 per staged
        # source per panel, 6 per target for the mean and the shift)
        ops = PANEL_OPS[name] * n * g + (3 * t * g + 6 * n
                                         if name == "mxu_c" else 0)
        nbytes = 12 * n + 16 * g + 12 * n
        t_ops, t_mem = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound = 1e3 * max(t_ops, t_mem)
        bound_by = "operations" if t_ops >= t_mem else "bytes"
        log(f"[probe] {key}: kernel {res['ms'][name]:.3f} ms, plain "
            f"{p_ms:.3f} ms, bound {bound:.3f} ms ({bound_by}), err/term "
            f"scale {rel:.3e} (bound {PANEL_BOUND:.0e}), max abs err "
            f"{abs_err:.3e}")
        if not rel <= PANEL_BOUND:
            raise RuntimeError(f"{key}: error {rel} > {PANEL_BOUND}")
        rows.append({
            "name": key, "route": "cuda", "source": PANEL_SOURCE,
            "replaces": PANEL_REPLACES, "launches": launches[key],
            "max_abs_err": abs_err, "ms": res["ms"][name], "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "ms_runner": None, "bound_ms_runner": None,
            "rel_err_term_scale": rel, "pairs": n * g,
            "max_rel_diff_vs_vpu": res["diff"].get(name),
        })
    return rows


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
    paths = build.build_all(verbose=True)
    for name in paths:
        build.load(name)
    log(f"[build] {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    bad = kern.inv_sqrt_mismatches(DEVICE)
    log(f"[build] table_sweep's one-SFU 1/sqrt differs from IEEE sqrt and "
        f"division at {bad} floats of [2^-100, inf) (at most "
        f"{kern.INV_SQRT_TIES}: two per odd binade)")
    if bad > kern.INV_SQRT_TIES:
        raise RuntimeError(f"inv_sqrt_rn: {bad} mismatches")

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
    launches_step = dict(kern.LAUNCHES)
    log(f"[main] v5_bench n={cfg.n}: steps {['%.1f' % s for s in step_ms]} "
        f"ms, median {sorted(step_ms)[1]:.1f} ms/step; launches "
        f"{launches_step}")
    for k, v in launches_step.items():
        if v == 0:
            raise RuntimeError(f"main path never launched {k}")
    check_finite("main", state)
    med, worst = direct_check(prev, state.acc, cfg)
    log(f"[main] acceleration vs float64 direct sum at 4096 bodies: median "
        f"rel err {med:.3e} (bound 2e-2), max {worst:.3e}")
    if not med < 0.02:
        raise RuntimeError(f"median force error {med} >= 2%")
    log(f"[main] KE {float(metrics.kinetic_energy(state)):.6e}")

    profile_spans({"one main step": lambda: sim.step(state)})
    phases, (ps, ms, cells, ss, bands, tables) = phase_breakdown(cfg, state)
    log("[main] phases (ms): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
    band_report("main", cfg, cells, ss, bands)

    near_pairs_report("kernels main", cfg, bands)
    launches, runner_err, runner_ms = runner_phase(cfg, RUNNER_STEPS)

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
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[k][0], "bound_by": bnd[k][1], "library_ms": None,
            "ms_runner": runner_ms[k][0], "bound_ms_runner": runner_ms[k][1],
            "rel_err_main": rel, "rel_err_runner": runner_err[k][0],
            "rel_err_t512": geo_err["t512"][k],
            "rel_err_t128": geo_err["t128"][k],
            "launches_step": launches_step[k],
            "launches_per_step": launches_step[k] / len(step_ms),
        })
        log(f"[kernels main] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bnd[k][0]:.3f} ms ({bnd[k][1]}, "
            f"{100 * bnd[k][0] / k_ms:.1f}% of it reached), rel_err {rel:.3e}")

    tile_order_report("kernels main", bands, tables)

    rows += probe_phase()

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
