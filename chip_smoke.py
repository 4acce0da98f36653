#!/usr/bin/env python3
"""Smoke run of nbody_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from nbody_tpu_torch/csrc (one nvcc per source),
holds each force kernel against its plain PyTorch version at two 50k-body
geometries and at the shapes of the main path (the far sweep bit for bit:
every target that differs from plain in any bit is traced to a tie of the
one-SFU 1 / sqrt, its plain terms summed in list order giving both
outputs, or the run fails), then [far edges]: the far sweep bit
for bit at edge counts (n off any tile size, 0, 1, 7 and all live rows,
a live count past the rows, massless pads, the live list past one staged
chunk, the ensemble's and the main path's sizes), each timed against its
20-op bound and its arithmetic's ceiling.  Then it drives the paths of
the v5_bench preset (N = 1,000,000, force_tile 512, no_ss) with the
launch counts zeroed before each and read after it:
  [main]   the per-step rebuild, ``Simulation(cfg).step``: one warm-up
           and three timed steps, a profile, a per-phase breakdown, live
           band counts and an accuracy check against a direct sum;
  [runner] the adaptive band-reuse runner, ``Simulation.run_scan``, under
           the kilostep gate, ``tools.prof_kilostep.gate`` (its config is
           v5_bench with check_overflow=False): ``metrics.drift_protocol``
           from the initial conditions (1024
           steps in chunks of 32): energy drift (< 1% enforced, the 0.2%
           criterion reported), steps/s, rebuilds, launches, the force
           error after the run, each force kernel against its plain
           version on the runner's own skinned bands at the evolved
           state with its time and bound there, near_span's window-lane
           and live pairs, the tile orders' time, the host syncs of a
           32-step run and of inner steps (at most one per rebuild, none
           in an inner step), and
           profiles of one 32-step chunk and of one inner step;
           [far ceiling] lines give the far sweep's time at the 1M state,
           on the skinned bands and on rank 0's slab against its 20-op
           bound and its ceiling (pairs x 4 quarter-rate operations over
           16 lanes x SMs x the maximum SM clock) beside PR 6's time;
  [tools]  the runner's evolved state saved through
           ``tools.prof_mkhot`` to chip_scratch/hot1m.npz and loaded back
           bit for bit, then the measuring function of each ported tool
           on the card at that state, each at its own config, one line
           each: prof_fbias (the direct sum at 65,536 sampled bodies),
           prof_capdemand (also v5_bench's first-rebuild demand against
           its caps), prof_latestate, prof_tailtargets, prof_nearwin,
           prof_stale, prof_skinerr, prof_hotrate and prof_hotcfg (one
           skin-width cap; 16-step calls), prof_crash1m (one 128-step
           chunk), prof_rebuild and prof_runner (runs of 4, 8 and 16
           steps at the hot state, 32, 64 and 128 from the IC, each
           timed three times), prof_cells, prof_groups and
           prof_classify (stage prefixes of the rebuild), prof_winmask
           (the pack-stage A/B at its own 4096 x 1024 runs), prof_inner,
           prof_cycle, prof_cadence (the IC and the hot state, 32-step
           calls) and prof_view (24 frames of the hot state, not the
           tool's 500k IC), and the runner split at v5_bench: x from
           prof_inner's full body, y from prof_cadence's rebuilds less
           x; every force kernel must launch; then
           each force kernel against its plain version (the far sweep
           bit for bit) on prof_nearwin's skinned build, at the tools'
           own config (force_tile 256, super-supers) on the hot state,
           with its time and bound there;
  [probe]  ``nbody_tpu_torch.tools.prof_mxu`` at its own shape, the panel
           sweep kernel in its three variants, each held against its plain
           version, its time beside its bound and PR 6's time;
  [reference] ``Simulation(cfg, method="barnes_hut_reference")``, one step
           of the rope-walk oracle from the IC (made with no device named:
           CUDA by default), against a float64 direct sum and the
           production step, and both against float64 at the 16 bodies
           where they part most;
  [cli]    ``python -m nbody_tpu_torch run --preset v5_bench`` as a
           subprocess (its dump and checkpoint read back, the checkpoint
           dumped again byte for byte), then ``info`` and ``bench`` in
           this process;
  [render] the v5 preset (N = 500,000) after 16 steps of run_scan,
           rendered in both modes on the card and held against the CPU's
           frame;
  [view]   the live viewer at v5 over HTTP on 127.0.0.1: page, JPEG
           frame, stats, a camera drag, then frames/s over 10 s;
  [ensemble] 4 members of bh_100k through models.ensemble's
           make_ensemble_step, each bit-equal to step_barnes_hut alone;
  [shard]  the sharded_4m preset (N = 4,000,000 in 8 slabs) on 8 ranks
           that share the card (parallel/launch.spawn, backend gloo):
           16 steps of make_sharded_adaptive_runner against the
           single-process make_adaptive_runner on the same IC and pads
           (equal rebuild counts, pos and vel within rtol 1e-4, atol
           1e-3), per-rank times, host reads, collective bytes and
           paths, and the three force kernels on rank 0's slab (near_span
           also on the halo + fetch sources with rebased windows)
           against their plain versions;
  [bench]  ``python -m nbody_tpu_torch.bench`` in a process of its own:
           v5_bench in full (its drift must print as [runner]'s), then
           N = 100,000 with a rebuild every step and bh_4m, each line
           checked for every field and every force kernel's launches.
Every failing check raises (non-zero exit).  The line before the last is
one JSON object per kernel ({"kernels": [...]}, times in ms on this
card), preceded by the card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io as io_module
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# the H100's peaks, the operations a pair, the kernels' error bounds, the
# drift limits, the work count and the kernel/plain pairs are the port
# bench's (python -m nbody_tpu_torch.bench), so both read one count
from nbody_tpu_torch.bench import (BOUNDS, DRIFT_CRITERION, DRIFT_LIMIT,
                                   FLOPS_PER_PAIR, PEAK_BYTES, PEAK_FP32,
                                   kernel_calls, work)
from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.models import simulation
from nbody_tpu_torch.models.simulation import Simulation, sort_by_morton
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.ops import bbox, forces, integrate, panel
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.cuda import build, forces as kern
from nbody_tpu_torch.ops.cuda import panel as panel_kern
from nbody_tpu_torch.tools import (
    common as tool_common, prof_cadence, prof_capdemand, prof_cells,
    prof_classify, prof_crash1m, prof_cycle, prof_fbias, prof_groups,
    prof_hotcfg, prof_hotrate, prof_inner, prof_kilostep, prof_latestate,
    prof_mkhot, prof_mxu, prof_nearwin, prof_rebuild, prof_runner,
    prof_skinerr, prof_stale, prof_tailtargets, prof_view, prof_winmask)
from nbody_tpu_torch.tools.prof_nearwin import live_lanes
from nbody_tpu_torch.utils import metrics

REPLACES = {
    "far_sweep": "nbody_tpu/ops/pallas/forces.py:125",
    "table_sweep": "nbody_tpu/ops/pallas/forces.py:214",
    "near_span": "nbody_tpu/ops/pallas/forces.py:408",
}
SOURCE = {
    "far_sweep": "nbody_tpu_torch/csrc/tile_sweeps.cu",
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
# The far and table sweeps' rounded, float64-summed arithmetic: operations
# a pair on the pipe that does QUARTER_LANES lanes per SM per clock (the
# rsqrt seed of inv_sqrt_rn and three float-to-double conversions)
QUARTER_OPS_PER_PAIR = 4
QUARTER_LANES = 16
# PR 6's times on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
PR6_FAR_MS = {"main": 0.221, "runner": 0.199, "shard": 0.397}
PR6_PANEL_MS = {"vpu": 5.492, "mxu": 6.232, "mxu_c": 6.226}
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


def compare(calls, label="", far_inputs=None):
    """Per kernel (max relative error against the plain total, max
    absolute error), each kernel against its plain version; and, with
    far_inputs = (pos, supers, cfg), the far sweep's count of targets that
    differ from plain in any bit (far_bit_check), else None."""
    outs = {k: (kfn(), pfn()) for k, (kfn, pfn) in calls.items()}
    sync()
    total = sum(p for _, p in outs.values()).norm(dim=1) + 1e-6
    res = {}
    for k, (ko, po) in outs.items():
        if not torch.isfinite(ko).all():
            raise RuntimeError(f"{k}: kernel output is not finite")
        diff = (ko - po).norm(dim=1)
        res[k] = (float((diff / total).max()), float((ko - po).abs().max()))
    differ = None
    if far_inputs is not None:
        differ = far_bit_check(label, *outs["far_sweep"], *far_inputs)
    return res, differ


def list_order_sum(terms):
    """Sum of the rows of a [live, 3] float32 tensor in float64, one row
    after another in list order (as the far kernel adds its terms),
    rounded to float32."""
    acc = [0.0, 0.0, 0.0]
    for row in terms.double().tolist():
        acc = [a + t for a, t in zip(acc, row)]
    return torch.tensor(acc, dtype=torch.float64).float()


def far_bit_check(label, k_out, p_out, pos, ss, cfg):
    """The far sweep's contract: its output is bit-equal to the plain
    version's except at targets where some argument |d|^2 + soft is a tie
    of the one-SFU 1 / sqrt (inv_sqrt_rn differs there from IEEE sqrt and
    division), and the tie is the cause.  For each differing target the
    plain terms are computed again on the card as the plain version
    computes them and summed in list order in float64: with IEEE 1 / sqrt
    that sum must be the plain output bit for bit (the summation order
    does not show at this target), and with inv_sqrt_rn put in at the tie
    arguments alone it must be the kernel's output bit for bit.  Logs
    every differing target with its tie arguments; raises if one is not
    traced so.  Returns the number of differing targets."""
    bits = (k_out.view(torch.int32) != p_out.view(torch.int32)).any(dim=1)
    idx = torch.nonzero(bits).flatten().tolist()
    live = min(int(ss.n_supers), ss.gmass.shape[0])
    com, gmass = ss.com[:live], ss.gmass[:live]
    soft = forces.soft_term(cfg)
    untraced = []
    for i in idx:
        d = com - pos[i]
        x = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] + soft
        ieee = 1.0 / torch.sqrt(x)
        tie = kern.inv_sqrt_rn(x).view(torch.int32) != ieee.view(torch.int32)
        sums = []
        for inv in (ieee, torch.where(tie, kern.inv_sqrt_rn(x), ieee)):
            w = gmass * (inv * inv * inv)
            sums.append(list_order_sum(w[:, None] * d))
        as_plain = bool((sums[0].view(torch.int32)
                         == p_out[i].cpu().view(torch.int32)).all())
        as_kernel = bool((sums[1].view(torch.int32)
                          == k_out[i].cpu().view(torch.int32)).all())
        ties = torch.nonzero(tie).flatten().tolist()
        args = ", ".join(f"source {j}: {float(x[j]):.9g} "
                         f"(0x{int(x[j:j + 1].view(torch.int32)) & 0xFFFFFFFF:08x})"
                         for j in ties)
        log(f"[{label}] far_sweep target {i} differs from plain "
            f"(kernel {k_out[i].tolist()}, plain {p_out[i].tolist()}); "
            f"inv_sqrt_rn ties among its arguments |d|^2 + soft: "
            f"{args or 'none'}; list-order float64 sum with IEEE terms "
            f"{'is' if as_plain else 'is NOT'} the plain output, with "
            f"inv_sqrt_rn at the ties {'is' if as_kernel else 'is NOT'} "
            f"the kernel's")
        if not (ties and as_plain and as_kernel):
            untraced.append(i)
    log(f"[{label}] far_sweep bit_equal: {pos.shape[0] - len(idx)} of "
        f"{pos.shape[0]} targets bit-equal to plain, {len(idx)} differ "
        f"({len(idx) - len(untraced)} traced to inv_sqrt_rn ties)")
    if untraced:
        raise RuntimeError(f"[{label}] far_sweep differs from plain at "
                           f"targets {untraced[:20]} not traced to an "
                           f"inv_sqrt_rn tie")
    return len(idx)


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0])


def ceiling_ms(pairs):
    """Least time of the far and table sweeps' arithmetic for `pairs`
    pairs: QUARTER_OPS_PER_PAIR operations a pair on the pipe of
    QUARTER_LANES lanes per SM per clock, on every SM at the maximum SM
    clock."""
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    rate = QUARTER_LANES * sms * sm_clock_mhz() * 1e6
    return 1e3 * QUARTER_OPS_PER_PAIR * pairs / rate


def ceiling_note(k, pairs, ms):
    """For the far and table sweeps, which share the rounded arithmetic,
    their ceiling and the share of it reached (for the log lines)."""
    if k not in ("far_sweep", "table_sweep"):
        return ""
    ceil = ceiling_ms(pairs)
    return (f"; arithmetic ceiling {ceil:.4f} ms, {100 * ceil / ms:.1f}% of "
            f"it reached")


def far_ceiling_report(label, ms, bound, pairs, pr6_ms):
    """The [far ceiling] line: the far sweep's time against its 20-op bound
    and against its arithmetic's ceiling."""
    ceil = ceiling_ms(pairs)
    log(f"[far ceiling {label}] {pairs:.4e} pairs, kernel {ms:.4f} ms (PR 6 "
        f"{pr6_ms:.3f} ms); 20-op FP32 bound {bound:.4f} ms, "
        f"{100 * bound / ms:.1f}% of it reached; arithmetic ceiling "
        f"{ceil:.4f} ms = pairs x {QUARTER_OPS_PER_PAIR} ops / "
        f"({QUARTER_LANES} lanes x "
        f"{torch.cuda.get_device_properties(DEVICE).multi_processor_count} "
        f"SMs x {sm_clock_mhz():.0f} MHz), {100 * ceil / ms:.1f}% of it "
        f"reached")


def bounds_ms(cfg, ps, ss, bands, tables, n_src=None):
    """Least time for each kernel's work on this run's data (bench.work:
    live pairs, inputs read once, outputs written once): the larger of
    FP32 operations over the FP32 peak and bytes over the memory rate;
    (ms, bound_by, pairs).  n_src: the near sweep's source rows (default:
    the targets)."""
    out = {}
    for k, w in work(cfg, ps, ss, bands, tables, n_src).items():
        t_ops = FLOPS_PER_PAIR * w["live"] / PEAK_FP32
        t_mem = w["bytes"] / PEAK_BYTES
        out[k] = (1e3 * max(t_ops, t_mem),
                  "operations" if t_ops >= t_mem else "bytes", w["live"])
    return out


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
    """The runner's first rebuild of a run_scan call at `state`
    (tools.common.first_rebuild, envelopes for rebuild_every steps):
    (pos, mass, cells, ss, bands, tables, s_valid, k_next)."""
    rebuild, args = tool_common.first_rebuild(state, cfg)
    (pos, _, mass, _, _, _), (cells, ss, bands, tables, _), (
        s_valid, k_next) = rebuild(*args)
    return pos, mass, cells, ss, bands, tables, s_valid, k_next


def check_geometry(label, cfg):
    state = make_initial_state(cfg, device=DEVICE)
    ps, ms, cs, _ = sorted_inputs(cfg, state)
    _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    calls = kernel_calls(cfg, ps, ms, ss, bands, tables)
    errs, differ = compare(calls, f"kernels {label}", (ps, ss, cfg))
    for k, (kfn, pfn) in calls.items():
        rel, _ = errs[k]
        k_ms, p_ms = event_ms(kfn, 10), event_ms(pfn, 2)
        log(f"[kernels {label}] {k}: rel_err {rel:.3e} (bound "
            f"{BOUNDS[k]:.0e})  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms")
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} at {label}: error {rel} > {BOUNDS[k]}")
    return {k: v[0] for k, v in errs.items()}, differ


def phase_breakdown(cfg, state):
    """One step phase by phase with a device sync around each phase;
    returns (per-phase ms, the sorted inputs and band structures).  It
    stays beside tools.prof_rebuild.phases, which times each phase of a
    skinned rebuild alone: this one is [main]'s whole per-step path
    (force kernels and integration too), and kernel_calls needs the
    structures it returns."""
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
    """Band demand per tile (the tools' mean/p999/max) and the overflow
    flags."""
    names = ("ss", "sup", "mid", "cmid", "near", "wins")
    log(f"[{label}] n_cells {int(cells.n_cells)} / {cfg.cell_capacity}, "
        f"tiles {bands.win_cnt.shape[0]}, n_ss live {int(ss.n_supers)}; "
        f"per tile mean/p999/max " + tool_common.quantile_text(
            names, tool_common.band_quantiles(bands, names)))
    log(f"[{label}] overflow {tool_common.overflow_flags(cells, bands)}")


def direct_check(prev, acc, cfg, n_targets=4096, seed=7):
    """Median and maximum relative error of `acc` at n_targets random
    bodies against a float64 direct sum over all sources (the bound of
    tests/test_forces.py's grouped-vs-direct test: 2% on the median)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randperm(prev.n, generator=gen, device=DEVICE)[:n_targets]
    ref = tool_common.direct_sum(prev, cfg, idx, torch.float64)
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


def runner_phase(base, steps, chunk=32):
    """The adaptive runner under the kilostep gate (prof_kilostep.gate:
    drift_protocol from the initial conditions) at the gate's config,
    which is `base` with check_overflow=False; returns its launch counts,
    per force kernel on the runner's skinned bands at the evolved state
    its (relative, absolute) error against the plain version and its
    (time, bound) in ms, and the protocol's result."""
    cfg = prof_kilostep.make_config(base.rebuild_every, base.hold_farmid,
                                    base.n)
    if cfg != base.replace(check_overflow=False):
        raise RuntimeError("prof_kilostep's config differs from v5_bench")
    ic = make_initial_state(cfg, device=DEVICE)
    sync()
    kern.reset_launches()
    res = prof_kilostep.gate(ic, cfg, steps, chunk=chunk, log_every=0)
    sim = res["sim"]
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
    errs, differ = compare(calls, "kernels runner", (pos, ss, cfg))
    bnd = bounds_ms(cfg, pos, ss, bands, tables)
    timing = {}
    for k, (rel, abs_err) in errs.items():
        timing[k] = (event_ms(calls[k][0], 10), bnd[k][0])
        log(f"[kernels runner] {k}: rel_err {rel:.3e} (bound "
            f"{BOUNDS[k]:.0e}), max abs err {abs_err:.3e}; kernel "
            f"{timing[k][0]:.3f} ms, bound {bnd[k][0]:.3f} ms ({bnd[k][1]}, "
            f"{100 * bnd[k][0] / timing[k][0]:.1f}% of it reached)"
            + ceiling_note(k, bnd[k][2], timing[k][0]))
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} on the runner's bands: error {rel} > "
                               f"{BOUNDS[k]}")
    far_ceiling_report("runner", timing["far_sweep"][0], bnd["far_sweep"][0],
                       bnd["far_sweep"][2], PR6_FAR_MS["runner"])
    tile_order_report("kernels runner", bands, tables)
    check_syncs(sim, ic, nxt, chunk)
    stepper = sim.make_stepper(nxt)
    profile_spans({
        "one inner step (with a far+mid refresh)": lambda: stepper.advance(1),
        f"one run_scan chunk of {chunk} steps": lambda: sim.run_scan(nxt,
                                                                     chunk),
    })
    return launches, errs, timing, differ, res


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


# [tools]: the cuts of depth that keep the
# phase under 200 s at 1M (PERF.md section 4)
TOOLS_FBIAS_ROWS = 1 << 16   # bodies whose direct sum prof_fbias takes
TOOLS_RATE_STEPS = 16        # run_scan calls of prof_hotrate, prof_hotcfg
TOOLS_RUNNER_STEPS = (4, (8, 16))  # prof_runner's runs at the hot state
TOOLS_ALPHA = 0.75           # prof_hotcfg's one skin-width cap
TOOLS_CADENCE_STEPS = 32     # prof_cadence's runner calls (tool: 64)


def v5_demand_report(cfg, dem):
    """(text, summary): the v5_bench caps against the demand of its first
    rebuild of a run_scan call (rebuild_every-step skins) under huge
    caps."""
    caps = {"sup": cfg.sup_cap, "mid": cfg.mid_cap, "cmid": cfg.cmid_cap,
            "near": cfg.near_cap, "wins": cfg.win_cap_eff}
    over = [k for k, c in caps.items() if dem[k]["max"] > c]
    text = ("v5_bench, 16-step skins: " + ", ".join(
        f"{k} max {dem[k]['max']} p999 {dem[k]['p999']} / cap {c}"
        for k, c in caps.items()) + f"; past the cap: {over or 'none'}")
    return text, {k: (dem[k]["max"], dem[k]["p999"], c)
                  for k, c in caps.items()}


def tools_phase(base, state, step, e_hot):
    """The ported tools of nbody_tpu_torch.tools at the runner's evolved
    1M state: saved through prof_mkhot and loaded back bit for bit, then
    each tool's measuring function on the card, one [tools] line each;
    then each force kernel against its plain version on prof_nearwin's
    skinned build at the tools' config (outside the counted launches).
    Returns the launch counts, that comparison {kernel: (relative
    error, absolute error, ms, bound ms)} with the far sweep's count of
    targets that differ in any bit, and a summary for the [slice]
    line."""
    path = tool_common.HOT_STATE
    prof_mkhot.save_hot(path, state, step)
    hot, at = tool_common.load_state(path, device=DEVICE)
    if at != step or not all(torch.equal(a, b) for a, b in zip(hot, state)):
        raise RuntimeError(f"{path} did not load back bit for bit")
    n = hot.n
    secs, out = {}, {}
    kern.reset_launches()

    def run(name, fn):
        t0 = time.perf_counter()
        r = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return r

    def finite(name, *xs):
        if not all(np.isfinite(x) for x in xs):
            raise RuntimeError(f"[tools] {name}: non-finite result {xs}")

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    rows = torch.randperm(n, generator=gen, device=DEVICE)[:TOOLS_FBIAS_ROWS]
    fcfg = prof_fbias.make_config(n)
    a_ref = run("direct", lambda: prof_fbias.direct_reference(hot, fcfg,
                                                              rows))
    r = run("prof_fbias", lambda: prof_fbias.probe(hot, fcfg, a_ref, e_hot,
                                                   rows))
    finite("prof_fbias", r["p_err"], r["rel_mean"])
    log(f"[tools] prof_fbias (ship; direct sum at {r['rows']} of {n} bodies, "
        f"{secs['direct']:.1f} s): " + prof_fbias.report("", r, secs[
            "prof_fbias"]).replace("\n    ", " | ")
        + f"; P_err over the sample {r['p_err']:+.4e}, sum |m v.da| "
        f"{r['p_abs']:.4e}")
    out["fbias"] = {k: r[k] for k in ("p_err_scaled", "drift_128", "rel_mean",
                                      "rel_max", "q99", "overflow")}

    ccfg = prof_capdemand.make_config(n).replace(**prof_capdemand.BIG)
    parts = []
    for label, skins in (("hot skins", True), ("hot live ", False)):
        r = run(f"prof_capdemand {label}", lambda: prof_capdemand.demand(
            hot, ccfg, skins))
        parts.append(prof_capdemand.report(label, r))
    r = run("prof_capdemand v5_bench", lambda: prof_capdemand.demand(
        hot, base.replace(**prof_capdemand.BIG), True))
    text, out["v5_demand"] = v5_demand_report(base, r)
    log("[tools] prof_capdemand " + " | ".join(parts + [text]))

    r = run("prof_latestate", lambda: prof_latestate.late_state(
        hot, prof_latestate.make_config(n)))
    log("[tools] prof_latestate " + " | ".join(
        prof_latestate.report(k, x).replace("\n     ", " |")
        for k, x in r.items()))

    r = run("prof_tailtargets", lambda: prof_tailtargets.tail(
        hot, prof_tailtargets.make_config(n).replace(**prof_capdemand.BIG)))
    log(f"[tools] prof_tailtargets: box {r['size']:.0f}, max sub-radius p50 "
        f"{r['rad_p50']:.1f} p99 {r['rad_p99']:.1f}; top near tile "
        + ", ".join(f"{k} {v}" for k, v in r["top"]["near"][0].items()
                    if k != "subrad")
        + f", largest sub-radius {r['top']['near'][0]['subrad'][0]:.1f}; "
        f"fat tiles {r['fat']} ({r['fat_share']:.3%}), "
        f"near p50/max {r['fat_near_p50']:.0f}/{r['fat_near_max']}; others "
        f"p999/max {r['thin_near_p999']:.0f}/{r['thin_near_max']}")

    ncfg = prof_nearwin.make_config(n)
    parts = []
    for label, skins in (("live", False), ("skins", True)):
        r = run(f"prof_nearwin {label}", lambda: prof_nearwin.window_stats(
            hot, ncfg, skins))
        finite("prof_nearwin", r["near_ms"], r["farmid_ms"])
        parts.append(prof_nearwin.report(label, r, "cuda")
                     .replace(f"\n[{label}]", " |"))
    log("[tools] prof_nearwin " + " | ".join(parts))

    r = run("prof_stale", lambda: prof_stale.stale(
        hot, prof_stale.make_config(n)))
    log("[tools] prof_stale " + prof_stale.report(r).replace("\n  ", " | "))
    out["stale"] = {j: {k: v["med"] for k, v in x.items()}
                    for j, x in r["j"].items()}

    r = run("prof_skinerr", lambda: prof_skinerr.skin_error(
        hot, prof_skinerr.make_config(n)))
    log("[tools] prof_skinerr " + " | ".join(
        prof_skinerr.report(k, x) for k, x in r.items()))
    out["skinerr"] = {k: x["med"] for k, x in r.items()}

    r = run("prof_hotrate", lambda: prof_hotrate.sustained(
        hot, prof_hotrate.make_config(n), steps=TOOLS_RATE_STEPS))
    log(f"[tools] prof_hotrate ({TOOLS_RATE_STEPS}-step calls, "
        f"{r['rebuilds']} rebuilds timed) " + prof_hotrate.report("hot", r))
    out["hotrate_ms"] = r["ms_per_step"]

    r = run("prof_hotcfg", lambda: prof_hotcfg.alpha_run(
        hot, prof_hotcfg.make_config(n), TOOLS_ALPHA, TOOLS_RATE_STEPS))
    log("[tools] prof_hotcfg " + prof_hotcfg.report(TOOLS_ALPHA, r)
        .replace("\n ", " |"))

    ccfg = prof_crash1m.make_config(n)
    r = run("prof_crash1m", lambda: prof_crash1m.chunk(hot, ccfg, 128))
    check_finite("prof_crash1m", r["state"])
    log(f"[tools] prof_crash1m ({r['rebuilds']} rebuilds)"
        + prof_crash1m.report(128, r))

    r = run("prof_rebuild", lambda: prof_rebuild.phases(
        hot, prof_rebuild.make_config(n)))
    log("[tools] prof_rebuild at the hot state: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in r["ms"].items())
        + f"; n_cells {r['n_cells']}")
    out["rebuild_ms"] = r["ms"]

    rcfg = prof_runner.make_config(n)
    parts = []
    # the hot state, cut, and the IC at the tool's own runs: there the
    # rebuild cadence varies, so the fit can separate a step from a rebuild
    for label, st, (steps, fit_steps) in (
            ("hot", hot, TOOLS_RUNNER_STEPS),
            ("IC", make_initial_state(rcfg, device=DEVICE),
             (32, prof_runner.FIT_STEPS))):
        r = run(f"prof_runner {label}", lambda: prof_runner.closure(
            st, rcfg, steps, fit_steps))
        f = r["fit"]
        parts.append(f"{label}: " + ", ".join(
            f"{s} steps {x['ms']:.1f} ms ({x['rebuilds']} rebuilds)"
            for s, x in r["runs"].items())
            + f"; one rebuild {r['rebuild']['ms']:.2f} ms (s_valid "
            f"{r['rebuild']['s_valid']}, k_next {r['rebuild']['k_next']}); "
            f"fit of the medians of {prof_runner.REPS} x {f['x_ms']:.2f} "
            f"ms/step, y {f['y_ms']:.2f} ms/rebuild ({f['y_from']}), c "
            f"{f['c_ms']:.1f} ms (rank {f['rank']}); each repetition's own "
            f"fit: " + ", ".join(f"{k[0]} {lo:.2f}..{hi:.2f}" for k, (
                lo, hi) in r["spread"].items())
            + f"; a step with its share of the rebuilds "
            f"{f['step_ms']:.2f} ms; run ms " + ", ".join(
                f"{s}: " + "/".join(f"{t:.1f}" for t in x["ms_all"])
                for s, x in r["runs"].items()))
        out[f"runner_fit_{label}"] = dict(f, spread=r["spread"])
    log("[tools] prof_runner " + " | ".join(parts))
    out.update(stage_tools(base, hot, run, finite, {
        k: out[f"runner_fit_{k}"] for k in ("IC", "hot")}))
    launches = dict(kern.LAUNCHES)
    log(f"[tools] launches {launches}; seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.1f} s")
    for k, v in launches.items():
        if v == 0:
            raise RuntimeError(f"[tools] never launched {k}")
    out["seconds"] = secs

    # the kernels at the tools' own shapes: force_tile 256, super-supers,
    # the hot state's skinned bands (the largest live counts they make)
    ps, ms, ss, bands, tables = prof_nearwin.build(hot, ncfg, True)
    near_pairs_report("kernels tools", ncfg, bands)
    calls = kernel_calls(ncfg, ps, ms, ss, bands, tables)
    errs, differ = compare(calls, "kernels tools", (ps, ss, ncfg))
    bnd = bounds_ms(ncfg, ps, ss, bands, tables)
    kernels = {}
    for k, (rel, abs_err) in errs.items():
        k_ms = event_ms(calls[k][0], 10)
        kernels[k] = (rel, abs_err, k_ms, bnd[k][0])
        log(f"[kernels tools] {k}: rel_err {rel:.3e} (bound "
            f"{BOUNDS[k]:.0e}), max abs err {abs_err:.3e}; kernel "
            f"{k_ms:.3f} ms, bound {bnd[k][0]:.3f} ms ({bnd[k][1]}, "
            f"{100 * bnd[k][0] / k_ms:.1f}% of it reached)"
            + ceiling_note(k, bnd[k][2], k_ms))
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} on the tools' bands: error {rel} > "
                               f"{BOUNDS[k]}")
    return launches, (kernels, differ), out


def stage_tools(base, hot, run, finite, fits):
    """The rebuild's stage prefixes, the pack-stage A/B, the inner step,
    the K-cycle, the cadence and the view rate at the hot state (`run`
    times each and synchronises; `finite` raises on a non-finite
    number), one [tools] line each, and the runner split at v5_bench:
    x, an inner step, from prof_inner's full body, and y = (prof_cadence
    ms/step x steps - x steps) / rebuilds, the rest of a run's time per
    rebuild, beside prof_runner's `fits` ({"IC", "hot"}: its fit at its
    own config).  Returns their summary for the [slice] line."""
    n = hot.n
    out = {}
    r = run("prof_cells", lambda: prof_cells.stage_times(
        hot, prof_cells.make_config(n)))
    finite("prof_cells", *r["ms"].values())
    log(f"[tools] prof_cells at the hot state ({r['n_cells']} cells), "
        f"cumulative ms (aten ops): " + ", ".join(
            f"{k} {v:.2f} ({r['ops'][k]})" for k, v in r["ms"].items()))
    out["cells"] = {"ms": r["ms"], "ops": r["ops"]}

    r = run("prof_groups", lambda: prof_groups.phases(
        hot, prof_groups.make_config(n)))
    log(f"[tools] prof_groups at the hot state (30-bit, drift "
        f"{prof_groups.DRIFT}; {r['n_cells']} cells), median/min: "
        + ", ".join(f"{k} {t['median_ms']:.2f}/{t['min_ms']:.2f} ms"
                    for k, t in r["ms"].items()) + "; bands per tile "
        + " ".join(f"{k}={s / r['tiles']:.1f}"
                   for k, s in r["band_sums"].items()))
    out["groups_ms"] = {k: t["median_ms"] for k, t in r["ms"].items()}

    ccfg = prof_classify.make_config(n)
    r = run("prof_classify", lambda: prof_classify.stage_times(hot, ccfg))
    finite("prof_classify", *r["ms"].values())
    counts = r["counts"]
    log(f"[tools] prof_classify at the hot state (unskinned, win_pieces "
        f"{ccfg.win_pieces}), cumulative ms (aten ops): " + ", ".join(
            f"{k} {v:.2f} ({r['ops'][k]})" for k, v in r["ms"].items())
        + "; mean per tile: ss {:.1f}, sup {:.1f}, mid {:.1f}, cmid {:.1f}, "
        "near {:.1f}, windows {:.1f}".format(*(
            float(x.to(torch.float32).mean()) for x in (
                counts["compact0"], counts["compact1"], counts["compact2"],
                counts["compact3"][:, 0], counts["compact3"][:, 1],
                counts["windows"]))))
    out["classify"] = {"ms": r["ms"], "ops": r["ops"]}

    first, count = (torch.from_numpy(x).to(DEVICE)
                    for x in prof_winmask.runs(4096, 1024))
    r = run("prof_winmask", lambda: prof_winmask.ab(first, count))
    log("[tools] prof_winmask (4096 rows, k 1024, win_cap 128): "
        + prof_winmask.report(r).replace("\n", " | "))
    out["winmask_ms"] = r["ms"]

    icfg = prof_inner.make_config(n)
    r = run("prof_inner", lambda: prof_inner.inner(hot, icfg))
    finite("prof_inner", *r["ms_per_step"].values())
    log("[tools] prof_inner at the hot state (32 steps a row): "
        + prof_inner.report(r).replace("\n", " | "))
    out["inner_ms"] = r["ms_per_step"]

    r = run("prof_cycle", lambda: prof_cycle.cycle(
        hot, prof_cycle.make_config(n)))
    finite("prof_cycle", r["inner_ms"])
    log("[tools] prof_cycle at the hot state: "
        + prof_cycle.report(r).replace("\n", " | "))
    out["cycle"] = {k: {m: b[m] for m in ("build_ms", "apply_ms")}
                    for k, b in r["builds"].items()}

    kcfg = prof_cadence.make_config(n=n)
    parts = []
    for label, st in (("IC", make_initial_state(kcfg, device=DEVICE)),
                      ("hot", hot)):
        r = run(f"prof_cadence {label}", lambda: prof_cadence.cadence(
            st, kcfg, TOOLS_CADENCE_STEPS))
        check_finite(f"prof_cadence {label}", r["state"])
        parts.append(prof_cadence.report(label, r))
    log(f"[tools] prof_cadence K={kcfg.rebuild_every} R={kcfg.hold_farmid} "
        f"alpha={kcfg.skin_width_cap}, {TOOLS_CADENCE_STEPS}-step calls: "
        + " | ".join(parts))

    v5 = base.replace(check_overflow=False)
    rx = run("prof_inner v5_bench", lambda: prof_inner.inner(
        hot, v5, rows=(prof_inner.FULL,)))
    ry = run("prof_cadence v5_bench", lambda: prof_cadence.cadence(
        hot, v5, TOOLS_CADENCE_STEPS))
    check_finite("prof_cadence v5_bench", ry["state"])
    x, steps = rx["ms_per_step"][prof_inner.FULL], ry["steps"]
    y = (ry["ms_per_step"] - x) * steps / max(ry["rebuilds"], 1)
    finite("runner split", x, y)
    log(f"[tools] runner split (v5_bench at the hot state): x {x:.2f} ms an "
        f"inner step (prof_inner's full body, 32 steps, no rebuild), y "
        f"{y:.2f} ms a rebuild (prof_cadence {ry['ms_per_step']:.2f} "
        f"ms/step over {steps} steps with {ry['rebuilds']} rebuilds, less "
        f"x a step); {ry['ms_per_step']:.2f} ms a step with its rebuilds; "
        f"beside prof_runner's fit at its own config: " + ", ".join(
            f"{k} x {f['x_ms']:.2f}, y {f['y_ms']:.2f} ({f['y_from']})"
            for k, f in fits.items()))
    out["runner_split"] = {"x_ms": x, "y_ms": y,
                           "ms_per_step": ry["ms_per_step"],
                           "rebuilds": ry["rebuilds"], "steps": steps}

    r = run("prof_view", lambda: prof_view.view_rate(
        hot, prof_view.make_config(n)))
    finite("prof_view", r["fps"])
    log(f"[tools] prof_view at the hot state ({r['rebuilds']} rebuilds): "
        + prof_view.report(n, 1, r))
    out["view"] = {k: r[k] for k in ("fps", "ms_per_frame", "frames")}
    return out


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
        log(f"[probe] {key}: kernel {res['ms'][name]:.3f} ms (PR 6 "
            f"{PR6_PANEL_MS[name]:.3f} ms), plain {p_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({bound_by}, {100 * bound / res['ms'][name]:.1f}%"
            f" of it reached; PR 6 {100 * bound / PR6_PANEL_MS[name]:.1f}%), "
            f"err/term scale {rel:.3e} (bound {PANEL_BOUND:.0e}), max abs err "
            f"{abs_err:.3e}")
        if not rel <= PANEL_BOUND:
            raise RuntimeError(f"{key}: error {rel} > {PANEL_BOUND}")
        rows.append({
            "name": key, "path": "probe", "route": "cuda",
            "source": PANEL_SOURCE,
            "replaces": PANEL_REPLACES, "launches": launches[key],
            "max_abs_err": abs_err, "ms": res["ms"][name], "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "ms_runner": None, "bound_ms_runner": None,
            "rel_err_term_scale": rel, "pairs": n * g,
            "max_rel_diff_vs_vpu": res["diff"].get(name),
        })
    return rows


# --- this slice's entry points: the rope-walk oracle, the command line,
# --- the renderer and the live viewer

REFERENCE_WORST = 16       # bodies summed directly in float64
CLI_STEPS = 64
RENDER_STEPS = 16
VIEW_SECONDS = 10.0
# max |GPU frame - CPU frame| per pixel channel: the projection is the
# same float32 operations on both devices; a speed's three-term sum may
# reduce in another order (a colour's ulp), and the scatter adds are
# atomics on the GPU: "add" sums up to ~10^2 splats per pixel below the
# clip at 1 in another order, "depth" sums only depth ties
RENDER_BOUNDS = {"add": 1e-5, "depth": 1e-6}
MIN_LIT_PIXELS = 10_000    # of 1280 x 720: the frame shows the galaxy


def check_launches(label, launches):
    """Log a path's force-kernel launch counts; raises if one of the
    three never launched."""
    log(f"[{label}] launches {launches}")
    for k in ("far_sweep", "table_sweep", "near_span"):
        if launches[k] == 0:
            raise RuntimeError(f"[{label}] never launched {k}")
    return launches


def launches_since_reset(label):
    return check_launches(label, dict(kern.LAUNCHES))


def reference_phase(cfg, ic):
    """Simulation(method="barnes_hut_reference"): one step from the IC at
    cfg.n, its force against a float64 direct sum and against the
    production step's on the same state."""
    sim = Simulation(cfg, method="barnes_hut_reference", device=DEVICE)
    kern.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = sim.step(ic)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(kern.LAUNCHES)
    st = sim.walk_stats
    log(f"[reference] v5_bench n={cfg.n}: one barnes_hut_reference step "
        f"{ms:.1f} ms, {st['iterations']} lockstep iterations, "
        f"{st['host_reads']} host reads; force kernel launches {launches} "
        f"(the walk is plain PyTorch)")
    check_finite("reference", out)
    med, worst = direct_check(ic, out.acc, cfg)
    log(f"[reference] acceleration vs float64 direct sum at 4096 bodies: "
        f"median rel err {med:.3e} (bound 2e-2), max {worst:.3e}")
    if not med < 0.02:
        raise RuntimeError(f"reference median force error {med} >= 2%")
    prod = Simulation(cfg, device=DEVICE).step(ic)
    rel = (out.acc - prod.acc).norm(dim=1) / prod.acc.norm(dim=1)
    log(f"[reference] vs the production barnes_hut step on the same state: "
        f"median rel diff {float(rel.median()):.3e}, max "
        f"{float(rel.max()):.3e}")
    # which path is off where they part most: both against float64, as a
    # relative error and as an absolute one over the median |a| (the rel
    # diff above divides by the production |a|, small at these bodies)
    worst = torch.topk(rel, REFERENCE_WORST).indices
    ref = tool_common.direct_sum(ic, cfg, worst, torch.float64)
    ref_norm = ref.norm(dim=1)
    scale = float(prod.acc.norm(dim=1).median())
    err = {name: (a[worst].double() - ref).norm(dim=1)
           for name, a in (("oracle", out.acc), ("production", prod.acc))}
    for i in range(REFERENCE_WORST):
        log(f"[reference] body {int(worst[i])}: |a64| {float(ref_norm[i]):.4e}"
            f" ({float(ref_norm[i]) / scale:.4f} of the median |a|), oracle "
            f"vs production {float(rel[worst[i]]):.4e}; error vs float64 "
            f"(relative; absolute / median |a|): oracle "
            f"{float(err['oracle'][i] / ref_norm[i]):.4e}; "
            f"{float(err['oracle'][i]) / scale:.4e}, production "
            f"{float(err['production'][i] / ref_norm[i]):.4e}; "
            f"{float(err['production'][i]) / scale:.4e}")
    summary = {name: {"median_rel": float((e / ref_norm).median()),
                      "max_rel": float((e / ref_norm).max()),
                      "max_abs_over_median_a": float(e.max()) / scale}
               for name, e in err.items()}
    off = max(summary, key=lambda k: summary[k]["median_rel"])
    log(f"[reference] at the {REFERENCE_WORST} bodies where the paths part "
        f"most (median |a| {scale:.4e}), error vs float64: "
        f"{json.dumps(summary)}; the path further off: {off}")
    return {"ms": ms, **st, "worst_bodies": [int(i) for i in worst],
            "worst_error": summary, "worst_path_off": off}


def cli_phase():
    """`python -m nbody_tpu_torch run` at v5_bench as a subprocess (dump
    and checkpoint read back; its kernel launches read from its stderr),
    then `info` and `bench` in this process."""
    from nbody_tpu_torch import cli
    from nbody_tpu_torch.native import runtime
    from nbody_tpu_torch.utils import io

    log(f"[cli] native runtime: {runtime.status()}")
    if not runtime.available():
        raise RuntimeError("the native runtime did not build")
    cfg = PRESETS["v5_bench"]
    res = {}
    with tempfile.TemporaryDirectory() as d:
        dump, ck = os.path.join(d, "out_bh.txt"), os.path.join(d, "ck.npz")
        cmd = [sys.executable, "-m", "nbody_tpu_torch", "run", "--preset",
               "v5_bench", "--steps", str(CLI_STEPS), "--log-every", "16",
               "--diagnostics", "--dump", dump, "--checkpoint", ck]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        res["run_s"] = time.perf_counter() - t0
        for line in done.stdout.splitlines():
            if line.startswith(("Step", "wrote")):
                log(f"[cli run] {line}")
        for line in done.stderr.splitlines():
            log(f"[cli run stderr] {line}")
        if done.returncode != 0:
            raise RuntimeError(f"cli run exited {done.returncode}")
        out = done.stdout
        summ = json.loads(out[out.index("{"):out.rindex("}") + 1])
        log(f"[cli run] summary {json.dumps(summ)}")
        log(f"[cli run] wall {res['run_s']:.1f} s for {CLI_STEPS} steps at "
            f"n={cfg.n} (process start, IC, kernel load, dump and checkpoint "
            f"included)")
        tag = "kernel launches: "
        res["launches_run"] = check_launches("cli run", json.loads(
            [l for l in done.stderr.splitlines()
             if l.startswith(tag)][-1][len(tag):]))
        with open(dump) as f:
            head = [next(f) for _ in range(4)]
        want = ["# Barnes-Hut N-Body Simulation Results\n",
                f"# Final positions and velocities after {CLI_STEPS} steps\n",
                f"# Bodies: {cfg.n}, Theta: 0.50, dt: 0.020\n",
                "# Format: x y z vx vy vz\n"]
        if head != want:
            raise RuntimeError(f"dump header {head}")
        t0 = time.perf_counter()
        meta, rows = io.load_dump(dump)
        log(f"[cli] load_dump: {rows.shape[0]} rows x {rows.shape[1]} in "
            f"{time.perf_counter() - t0:.2f} s, meta {meta}")
        if rows.shape != (cfg.n, 6) or not np.isfinite(rows).all():
            raise RuntimeError(f"dump rows {rows.shape}")
        state, step = io.load_checkpoint(ck, device=DEVICE)
        if step != CLI_STEPS or state.device.type != "cuda":
            raise RuntimeError(f"checkpoint step {step} on {state.device}")
        check_finite("cli checkpoint", state)
        again = os.path.join(d, "again.txt")
        t0 = time.perf_counter()
        io.dump_state_text(again, state, cfg, CLI_STEPS)
        res["dump_write_s"] = time.perf_counter() - t0
        with open(dump, "rb") as a, open(again, "rb") as b:
            same = a.read() == b.read()
        log(f"[cli] checkpoint -> dump_state_text (native writer): "
            f"{res['dump_write_s']:.2f} s for {cfg.n} rows "
            f"({os.path.getsize(again) / 1e6:.1f} MB); byte-identical to "
            f"the run's dump: {same}")
        if not same:
            raise RuntimeError("the checkpoint does not round-trip to the "
                               "dump at %.6f")

    def in_process(label, argv):
        buf = io_module.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        for line in buf.getvalue().splitlines():
            log(f"[cli {label}] {line}")
        if rc != 0:
            raise RuntimeError(f"cli {label} returned {rc}")

    in_process("info", ["info"])
    kern.reset_launches()
    in_process("bench", ["bench", "--preset", "v5_bench", "--frames", "5",
                         "--phases"])
    res["launches_bench"] = launches_since_reset("cli bench")
    return res


def render_phase():
    """The v5 preset after RENDER_STEPS steps of run_scan, rendered in both
    modes on the card and on the CPU; returns (cfg, state)."""
    from nbody_tpu_torch.viz.render import render_state, write_ppm

    cfg = PRESETS["v5"]
    sim = Simulation(cfg, device=DEVICE)
    state = sim.init_state()
    kern.reset_launches()
    t0 = time.perf_counter()
    state = sim.run_scan(state, RENDER_STEPS)
    sync()
    log(f"[render] v5 n={cfg.n}: {RENDER_STEPS} steps of run_scan in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"launches": launches_since_reset("render")}
    check_finite("render", state)
    on_cpu = state.to("cpu")
    for mode, bound in RENDER_BOUNDS.items():
        gpu = render_state(state, cfg, mode).cpu()
        cpu = render_state(on_cpu, cfg, mode)
        diff = (gpu - cpu).abs()
        ms = event_ms(lambda: render_state(state, cfg, mode), 20)
        lit = int((cpu.sum(dim=2) > 0).sum())
        log(f"[render] {mode}: {cfg.render_width}x{cfg.render_height}, "
            f"{ms:.3f} ms per frame on the card; vs the CPU render: max "
            f"|diff| {float(diff.max()):.3e} (bound {bound:.0e}), "
            f"{int((diff > 0).any(dim=2).sum())} of {lit} lit pixels differ")
        if not float(diff.max()) <= bound:
            raise RuntimeError(f"render {mode}: {float(diff.max())} > {bound}")
        if lit < MIN_LIT_PIXELS:
            raise RuntimeError(f"render {mode}: only {lit} lit pixels")
        res[f"{mode}_ms"] = ms
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.ppm")
        write_ppm(path, gpu)
        log(f"[render] wrote {os.path.getsize(path)} bytes of PPM")
    return cfg, state, res


def view_phase(cfg, state):
    """SimViewer at cfg (v5, 500k) on 127.0.0.1, an OS-chosen port: the
    page, a frame, the stats and a camera drag over HTTP, then the view
    rate over VIEW_SECONDS."""
    import urllib.request

    from PIL import Image

    from nbody_tpu_torch.viz.viewer import SimViewer, serve

    sim = Simulation(cfg, device=DEVICE)
    kern.reset_launches()
    viewer = SimViewer(sim, state, cfg)
    viewer.start()
    server = serve(viewer, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=120) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()

    try:
        status, ctype, page = get("/")
        if status != 200 or b"/stream" not in page:
            raise RuntimeError(f"GET / {status} {ctype}")
        status, ctype, jpeg = get("/frame.jpg")
        is_jpeg = jpeg[:2] == b"\xff\xd8"
        img = np.asarray(Image.open(io_module.BytesIO(jpeg)))
        log(f"[view] GET /frame.jpg: {status} {ctype}, {len(jpeg)} bytes, "
            f"JPEG {is_jpeg}, {img.shape[1]}x{img.shape[0]}, mean level "
            f"{img.mean():.2f}")
        if not is_jpeg or img.shape != (cfg.render_height, cfg.render_width,
                                        3):
            raise RuntimeError("/frame.jpg is not the frame")
        if not img.mean() > 0:
            raise RuntimeError("/frame.jpg is black")
        before = json.loads(get("/stats")[2])
        req = urllib.request.Request(
            url + "/cam", data=json.dumps({"drag_dx": 25, "drag_dy": -10,
                                           "scroll": 2}).encode(),
            method="POST")
        urllib.request.urlopen(req, timeout=60).read()
        s0 = json.loads(get("/stats")[2])
        moved = (s0["rot_y"] - before["rot_y"], s0["rot_x"] - before["rot_x"],
                 s0["distance"] - before["distance"])
        log(f"[view] POST /cam moved the camera by (rot_y, rot_x, distance) "
            f"= {moved}")
        if moved != (5.0, -2.0, -300.0):
            raise RuntimeError(f"camera moved by {moved}")
        t0 = time.perf_counter()
        time.sleep(VIEW_SECONDS)
        s1 = json.loads(get("/stats")[2])
        dt = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        viewer.stop()
    frames, steps = s1["frames"] - s0["frames"], s1["step"] - s0["step"]
    res = {"fps": frames / dt, "ms_per_step": 1e3 * dt / max(steps, 1),
           "rebuilds": viewer._stepper.n_rebuilds,
           "launches": launches_since_reset("view")}
    log(f"[view] v5 n={cfg.n}, {cfg.render_width}x{cfg.render_height} "
        f"JPEG: {frames} frames and {steps} steps in {dt:.1f} s: "
        f"{res['fps']:.2f} frames/s, {res['ms_per_step']:.1f} ms/step; "
        f"{res['rebuilds']} rebuilds since the viewer started")
    check_finite("view", viewer.state)
    if frames < 1:
        raise RuntimeError("the viewer published no frame")
    return res


# --- this slice's paths: the multi-device runner and the ensemble

SHARD_BACKEND = "gloo"     # the ranks share the one card
SHARD_STEPS = 16
SHARD_TIMEOUT = 900        # seconds for the whole spawned run
RUNNER_TOL = {"rtol": 1e-4, "atol": 1e-3}    # tests/test_shard.py's bound
ENSEMBLE_MEMBERS = 4


def shard_rank(mesh, cfg, n_steps):
    """One rank of [shard] (every rank runs it, SPMD): the IC from the
    seed, this rank's slab, make_sharded_adaptive_runner with the launch
    counts and collective bytes zeroed before it; then the same schedule
    stepped by hand, each step timed with its host syncs and bytes; then,
    on rank 0 (the others wait), the three force kernels on its slab's
    inputs after the last rebuild against their plain versions."""
    from nbody_tpu_torch.parallel import comm, shard

    def dev_sync():
        torch.cuda.synchronize(mesh.device)

    slab = shard.shard_state(make_initial_state(cfg, device=mesh.device),
                             mesh)
    kern.reset_launches()
    mesh.stats.clear()
    dev_sync()
    t0 = time.perf_counter()
    out, n_rb = shard.make_sharded_adaptive_runner(
        cfg, mesh, n_steps, return_stats=True)(slab)
    dev_sync()
    res = {"rank": mesh.rank, "wall_s": time.perf_counter() - t0,
           "rebuilds": n_rb, "launches": dict(kern.LAUNCHES),
           "stats": dict(mesh.stats),
           "finite": bool(torch.isfinite(out.pos).all()
                          and torch.isfinite(out.vel).all())}
    if mesh.rank == 0:
        res["pos"], res["vel"] = out.pos.cpu(), out.vel.cpu()
    del out

    loop = shard._ShardedAdaptiveLoop(cfg, mesh,
                                      *shard._slabs_of(slab, cfg, mesh))
    steps = []
    for _ in range(n_steps):
        rb0, before = loop.n_rebuilds, collections.Counter(mesh.stats)
        dev_sync()
        t0 = time.perf_counter()
        _, syncs = count_syncs(loop.step)
        dev_sync()
        ms = 1e3 * (time.perf_counter() - t0)
        delta = collections.Counter(mesh.stats)
        delta.subtract(before)
        rebuilt = loop.n_rebuilds > rb0
        steps.append({"rebuild": rebuilt, "ms": ms, "syncs": syncs,
                      "host_reads": syncs - delta["staged_syncs"],
                      "s_valid": loop.left + 1 if rebuilt else None,
                      "bytes": {k: v for k, v in delta.items() if v}})
    res.update(steps=steps, host_reads=loop.host_reads,
               paths=dict(loop.paths))

    res["rebuild_sums"] = loop.rebuild_sums
    # the near sweep's sources as the path builds them (collectives: all)
    _, ss, bands, tables, _ = loop.built
    glob, p, mass = loop.glob, loop.pos, loop.mass
    if glob.near_fast:
        p_src = shard._near_source_rows(p, glob, cfg, mesh)
        m_src, wf = glob.mass_src, glob.wf_remap
    else:
        p_src = comm.all_gather(p, mesh)
        m_src, wf = glob.mass_s, bands.win_first
    # the halo + fetch inputs (rebased windows) with a fetch cap that
    # holds for this state, whichever path the run took
    m = p.shape[0]
    h = shard._near_halo_rows(m, cfg)
    needed = comm.all_gather(
        shard._near_fetch_plan(bands, m, h, cfg, mesh)[0].reshape(1), mesh)
    fetch_cap = -(-int(needed.max()) // 128) * 128
    _, starts, wf_fast = shard._near_fetch_plan(
        bands, m, h, cfg.replace(near_fetch_cap=fetch_cap), mesh)
    reqs = comm.all_gather(starts, mesh).reshape(mesh.size, -1)
    p_fast = torch.cat([shard._halo_ext(p, h, mesh),
                        shard._fetch_windows(p, reqs, m, mesh)])
    m_fast = torch.cat([shard._halo_ext(mass, h, mesh),
                        shard._fetch_windows(mass, reqs, m, mesh)])
    p_all = comm.all_gather(p, mesh)
    if mesh.rank == 0:
        b = bands
        calls = {
            "far_sweep": (lambda: kern.far_sweep(p, ss, cfg),
                          lambda: forces.far_sweep_torch(p, ss, cfg)),
            "table_sweep": (lambda: kern.table_sweep(p, tables, cfg),
                            lambda: forces.table_sweep_torch(p, tables, cfg)),
            "near_span": (lambda: kern.near_span(p, p_src, m_src, wf,
                                                 b.win_mask, b.win_cnt, cfg),
                          lambda: forces.near_correction_torch(
                              p, p_src, m_src, wf, b.win_mask, b.win_cnt,
                              cfg)),
        }
        errs, differ = compare(calls, "kernels shard", (p, ss, cfg))
        bnd = bounds_ms(cfg, p, ss, bands, tables, n_src=p_src.shape[0])
        res["kernels"] = {
            k: {"rel_err": errs[k][0], "max_abs_err": errs[k][1],
                "ms": event_ms(calls[k][0], 10), "plain_ms": event_ms(
                    calls[k][1], 2), "bound_ms": bnd[k][0],
                "bound_by": bnd[k][1], "pairs": bnd[k][2]} for k in calls}
        res["kernels"]["far_sweep"]["bit_differ"] = differ
        # near_span on the halo + fetch sources and rebased windows:
        # against its plain version, and against itself on the gather
        fast = {"near_span": (
            lambda: kern.near_span(p, p_fast, m_fast, wf_fast, b.win_mask,
                                   b.win_cnt, cfg),
            lambda: forces.near_correction_torch(
                p, p_fast, m_fast, wf_fast, b.win_mask, b.win_cnt, cfg))}
        rel, abs_err = compare(fast)[0]["near_span"]
        gathered = kern.near_span(p, p_all, glob.mass_s, b.win_first,
                                  b.win_mask, b.win_cnt, cfg)
        res["near_fast"] = {
            "plan_holds": int(needed.max()) <= fetch_cap,
            "fetch_cap": fetch_cap,
            "far_windows_per_rank": [int(x) for x in needed],
            "n_src": p_fast.shape[0], "rel_err": rel, "max_abs_err": abs_err,
            "ms": event_ms(fast["near_span"][0], 10),
            "bitwise_as_gather": bool(torch.equal(fast["near_span"][0](),
                                                  gathered))}
        res["slab"] = {"targets": p.shape[0], "near_sources": p_src.shape[0],
                       "tiles": b.win_cnt.shape[0],
                       "near_windows": int(b.win_cnt.sum()),
                       "n_ss_live": int(ss.n_supers)}
    # the other ranks wait here while rank 0 times its kernels
    comm.psum(torch.zeros(1, device=mesh.device), mesh)
    return res


def runner_diff(got_pos, got_vel, want_pos, want_vel):
    """Max |got - want| and the max excess over RUNNER_TOL (<= 0 passes)
    of positions and velocities."""
    out = {}
    for name, g, w in (("pos", got_pos, want_pos), ("vel", got_vel, want_vel)):
        d = (g - w).abs()
        allow = RUNNER_TOL["atol"] + RUNNER_TOL["rtol"] * w.abs()
        out[name] = (float(d.max()), float((d - allow).max()))
    return out


def first_parting(want_steps, got_steps):
    """The first step whose rebuild flag differs, or None."""
    for i, (a, b) in enumerate(zip(want_steps, got_steps)):
        if a != b:
            return i
    return None


def shard_phase():
    """sharded_4m unchanged (N = 4M, 8 slabs) through
    make_sharded_adaptive_runner on 8 gloo ranks sharing the card, held
    against the single-process adaptive runner on the same IC; per-rank
    times, host reads, collective bytes and paths; the force kernels on
    rank 0's slab.  Returns (the kernel rows, a summary)."""
    from nbody_tpu_torch.parallel import launch
    from nbody_tpu_torch.state import ParticleState

    cfg = PRESETS["sharded_4m"]
    d = cfg.mesh_shape[0]
    ic = make_initial_state(cfg, device=DEVICE)
    # the sharded runner pads to a multiple of D * force_tile with massless
    # clones; the single-process run takes the same padded system
    pos, vel, mass, acc, _ = simulation._pad_cycle_state(
        ic, d * cfg.force_tile)
    padded = ParticleState(pos, vel, mass, acc)
    n_pads = padded.n - ic.n

    def single(state):
        kern.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out, rb = simulation.make_adaptive_runner(
            cfg, SHARD_STEPS, return_stats=True)(state)
        sync()
        return (out, rb, 1e3 * (time.perf_counter() - t0) / SHARD_STEPS,
                torch.cuda.max_memory_allocated(), dict(kern.LAUNCHES))

    want, want_rb, ms_step, peak, launches1 = single(padded)
    check_finite("shard single process", want)
    log(f"[shard single] sharded_4m's config on one process (bh_4m's shape), "
        f"the IC plus the sharded runner's {n_pads} massless pads "
        f"(n = {padded.n}): {SHARD_STEPS} steps of make_adaptive_runner, "
        f"{ms_step:.1f} ms/step, {want_rb} rebuilds, peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches1}")
    want_pos, want_vel = want.pos[:ic.n].cpu(), want.vel[:ic.n].cpu()
    alone, alone_rb, alone_ms, alone_peak, _ = single(ic)
    log(f"[shard single] the IC alone (n = {ic.n}, {ic.n % cfg.force_tile} "
        f"rows past a tile, padded to one): {alone_ms:.1f} ms/step, "
        f"{alone_rb} rebuilds, peak memory {alone_peak / 2**30:.2f} GiB")
    alone_pos, alone_vel = alone.pos.cpu(), alone.vel.cpu()
    del want, alone, padded, ic, pos, vel, mass, acc
    torch.cuda.empty_cache()

    log(f"[shard] {d} ranks on one card, backend {SHARD_BACKEND!r} "
        f"(collectives staged through pinned host buffers), "
        f"parallel/launch.spawn, timeout {SHARD_TIMEOUT} s")
    t0 = time.perf_counter()
    ranks = launch.spawn(shard_rank, d, backend=SHARD_BACKEND, device="cuda",
                         timeout=SHARD_TIMEOUT, args=(cfg, SHARD_STEPS))
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    log(f"[shard] spawn to last result {spawn_s:.1f} s; runner wall per rank "
        f"(s): {[round(r['wall_s'], 2) for r in ranks]}")

    # schedule and trajectory against the single process
    rbs = {r["rebuilds"] for r in ranks}
    diff = runner_diff(r0["pos"], r0["vel"], want_pos, want_vel)
    info = runner_diff(r0["pos"], r0["vel"], alone_pos, alone_vel)
    log(f"[shard] rebuilds: sharded {sorted(rbs)}, single process {want_rb}; "
        f"vs the single process (max |diff|, max excess over rtol 1e-4 "
        f"atol 1e-3): {diff}")
    log(f"[shard] vs the single process on the unpadded IC, another system "
        f"(not gated): {info}")
    if rbs != {want_rb} or want_rb < 2:
        sloop = simulation._AdaptiveLoop(cfg, make_initial_state(
            cfg, device=DEVICE))
        flags = []
        for _ in range(SHARD_STEPS):
            rb0 = sloop.n_rebuilds
            sloop.step()
            flags.append(sloop.n_rebuilds > rb0)
        part = first_parting(flags, [s["rebuild"] for s in r0["steps"]])
        raise RuntimeError(f"[shard] rebuild schedules: sharded {sorted(rbs)}"
                           f", single {want_rb} (at least 2 needed); they "
                           f"part at step {part}")
    if not all(r["finite"] for r in ranks) or max(
            v[1] for v in diff.values()) > 0:
        raise RuntimeError(f"[shard] sharded runner off the single process: "
                           f"{diff}")

    # per rank: times, host reads, bytes, paths
    for r in ranks:
        rb = [s for s in r["steps"] if s["rebuild"]]
        inner = [s for s in r["steps"] if not s["rebuild"]]
        reads_rb = [s["host_reads"] for s in rb]
        reads_in = [s["host_reads"] for s in inner]

        def per(steps, key):
            tot = collections.Counter()
            for s in steps:
                tot.update(s["bytes"])
            return {k: round(v / max(len(steps), 1))
                    for k, v in sorted(tot.items()) if not k.endswith("calls")
                    and k != key}

        log(f"[shard rank {r['rank']}] rebuild ms "
            f"{[round(s['ms'], 1) for s in rb]}, inner-step ms mean "
            f"{np.mean([s['ms'] for s in inner]):.1f} max "
            f"{max(s['ms'] for s in inner):.1f}; host reads per rebuild "
            f"{reads_rb} (loop count {r['host_reads']}), per inner step max "
            f"{max(reads_in)}; staged syncs per rebuild "
            f"{[s['syncs'] - s['host_reads'] for s in rb]}, per inner step "
            f"{inner[0]['syncs'] - inner[0]['host_reads']}; paths "
            f"{r['paths']}; launches {r['launches']}")
        log(f"[shard rank {r['rank']}] bytes per rebuild step "
            f"{per(rb, 'staged_syncs')}; per inner step "
            f"{per(inner, 'staged_syncs')} (staged: the card-host copies)")
        if max(reads_in) != 0 or max(reads_rb) > 1:
            raise RuntimeError(f"[shard rank {r['rank']}] host reads: "
                               f"rebuilds {reads_rb}, inner {reads_in}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("far_sweep", "table_sweep", "near_span")}
    check_launches("shard", launches)
    log(f"[shard] rank 0's slab after the last rebuild: {r0['slab']}; "
        f"s_valid per rebuild "
        f"{[s['s_valid'] for s in r0['steps'] if s['rebuild']]}; per rebuild "
        f"(rows outside the reslab halo, ranks over the fetch cap, ranks "
        f"overflowing a band cap), summed over the ranks: "
        f"{r0['rebuild_sums']}")
    nf = r0["near_fast"]
    log(f"[kernels shard] near_span on the halo + fetch sources with rebased "
        f"windows (n_src {nf['n_src']}, fetch cap {nf['fetch_cap']} for "
        f"{nf['far_windows_per_rank']} distinct out-of-halo windows per rank;"
        f" the preset's cap is {cfg.near_fetch_cap}): rel_err "
        f"{nf['rel_err']:.3e}, max abs err {nf['max_abs_err']:.3e}, "
        f"{nf['ms']:.3f} ms; bitwise equal to the gather path: "
        f"{nf['bitwise_as_gather']}")
    if not (nf["plan_holds"] and nf["rel_err"] <= BOUNDS["near_span"]
            and nf["bitwise_as_gather"]):
        raise RuntimeError(f"[shard] near_span on the halo + fetch inputs: "
                           f"{nf}")
    rows = []
    for k, kr in r0["kernels"].items():
        log(f"[kernels shard] {k}: rel_err {kr['rel_err']:.3e} (bound "
            f"{BOUNDS[k]:.0e}), max abs err {kr['max_abs_err']:.3e}; kernel "
            f"{kr['ms']:.3f} ms, plain {kr['plain_ms']:.3f} ms, bound "
            f"{kr['bound_ms']:.3f} ms ({kr['bound_by']}, "
            f"{100 * kr['bound_ms'] / kr['ms']:.1f}% of it reached)"
            + ceiling_note(k, kr["pairs"], kr["ms"]))
        if not kr["rel_err"] <= BOUNDS[k]:
            raise RuntimeError(f"{k} on the sharded slab: error "
                               f"{kr['rel_err']} > {BOUNDS[k]}")
        rows.append({
            "name": k, "path": "shard", "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "launches_per_rank": [r["launches"][k] for r in ranks],
            "max_abs_err": kr["max_abs_err"], "ms": kr["ms"],
            "plain_ms": kr["plain_ms"], "bound_ms": kr["bound_ms"],
            "bound_by": kr["bound_by"], "library_ms": None,
            "rel_err": kr["rel_err"]})
        if k == "far_sweep":
            rows[-1]["bit_differ"] = kr["bit_differ"]
            far_ceiling_report("shard", kr["ms"], kr["bound_ms"], kr["pairs"],
                               PR6_FAR_MS["shard"])
        if k == "near_span":
            rows[-1].update(n_src=r0["slab"]["near_sources"],
                            ms_halo_fetch=nf["ms"],
                            rel_err_halo_fetch=nf["rel_err"],
                            n_src_halo_fetch=nf["n_src"])
    summary = {"ranks": d, "backend": SHARD_BACKEND, "steps": SHARD_STEPS,
               "rebuilds": want_rb, "spawn_s": spawn_s,
               "single_ms_per_step": ms_step, "single_peak_gib": peak / 2**30,
               "diff": diff, "paths": r0["paths"]}
    return rows, summary


def ensemble_phase():
    """ENSEMBLE_MEMBERS members of bh_100k (seeds 42, 43, ...) through
    make_ensemble_step for one step, each member bit-equal to
    step_barnes_hut on that member alone; returns its launches."""
    from nbody_tpu_torch.models import ensemble

    cfg = PRESETS["bh_100k"]
    members = [make_initial_state(cfg.replace(seed=cfg.seed + e),
                                  device=DEVICE)
               for e in range(ENSEMBLE_MEMBERS)]
    batched = ensemble.stack_states(members)
    kern.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = ensemble.make_ensemble_step(cfg)(batched)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = launches_since_reset("ensemble")
    same = []
    for e, member in enumerate(members):
        alone = simulation.step_barnes_hut(member, cfg)
        same.append(all(torch.equal(x[e], y) for x, y in zip(out, alone)))
    log(f"[ensemble] bh_100k x {ENSEMBLE_MEMBERS} members (n={cfg.n} each): "
        f"one make_ensemble_step {ms:.1f} ms; each member bit-equal to "
        f"step_barnes_hut alone: {same}")
    if not all(same):
        raise RuntimeError(f"[ensemble] members differ from the lone step: "
                           f"{same}")
    check_finite("ensemble", out)
    return {"ms": ms, "launches": launches}


# [far edges]: (label, targets, super-super rows S, live count, massless
# rows at the end of the live prefix)
FAR_EDGES = [
    ("n=50,001", 50_001, 192, 105, 0),
    ("n_live=0", 50_001, 192, 0, 0),
    ("n_live=1", 50_001, 192, 1, 0),
    ("n_live=7", 50_001, 192, 7, 0),
    ("n_live=S", 50_001, 192, 192, 0),
    ("n_live>S (clamped)", 50_001, 192, 250, 0),
    ("massless pads ending the live prefix", 50_001, 192, 120, 16),
    ("n=100,000 (bh_100k's size)", 100_000, 192, 105, 0),
    ("S past one staged chunk", 20_000, 1600, 1500, 0),
    ("the 1M IC's sizes", 1_000_448, 192, 105, 0),
    ("a sharded_4m slab's sizes", 500_224, 576, 461, 0),
]


def far_edge_inputs(n, s, live, pads, seed):
    """n targets and S super-super rows on the card: coordinates of a thin
    disk of radius 1700, positive masses on the live rows but the last
    `pads` of them (massless at their positions), rows past the live count
    massless at the origin, as the band build pads them."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def disk(m):
        x = (torch.rand((m, 3), generator=gen, device=DEVICE) - 0.5) * 3400.0
        x[:, 2] *= 0.05
        return x

    pos, com = disk(n), disk(s)
    gmass = 1.0 + 1e4 * torch.rand((s,), generator=gen, device=DEVICE)
    k = min(live, s)
    gmass[k - pads:k] = 0.0
    gmass[k:] = 0.0
    com[k:] = 0.0
    zero = torch.zeros_like(gmass)
    return pos, forces.Supers(com=com, gmass=gmass, diam=zero, lo=com,
                              hi=com, skin=zero,
                              n_supers=torch.tensor(live, device=DEVICE))


def far_edges_phase(cfg):
    """[far edges]: the far sweep bit for bit against its plain version at
    the counts and sizes of FAR_EDGES (any n, any live count, the clamp,
    massless pads, more live rows than one staged chunk, the main path's
    sizes); one launch each, then its time against its 20-op bound and its
    arithmetic's ceiling.  Returns the number of differing targets, all
    traced to ties."""
    total = 0
    for i, (label, n, s, live, pads) in enumerate(FAR_EDGES):
        pos, ss = far_edge_inputs(n, s, live, pads, seed=i)
        kern.reset_launches()
        k_out = kern.far_sweep(pos, ss, cfg)
        if kern.LAUNCHES["far_sweep"] != 1:
            raise RuntimeError(f"[far edges] {label}: launches "
                               f"{kern.LAUNCHES['far_sweep']}")
        p_out = forces.far_sweep_torch(pos, ss, cfg)
        sync()
        total += far_bit_check(f"far edges {label}", k_out, p_out, pos, ss,
                               cfg)
        pairs = n * min(live, s)
        ms = event_ms(lambda: kern.far_sweep(pos, ss, cfg), 20)
        bound = 1e3 * FLOPS_PER_PAIR * pairs / PEAK_FP32
        ceil = ceiling_ms(pairs)
        log(f"[far edges] {label}: n={n}, S={s}, n_live={live}, {pads} "
            f"massless pads in the live prefix; {kern.far_blocks(n)} blocks; "
            f"max |plain| {float(p_out.abs().max()):.4e}; "
            f"kernel {ms:.4f} ms, 20-op bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f}%), arithmetic ceiling {ceil:.4f} ms "
            f"({100 * ceil / ms:.1f}%)")
    return total


# [bench]: python -m nbody_tpu_torch.bench at v5_bench in full (1024
# drift steps in chunks of 32, the selfcheck), then BASELINE.json's
# config 2 (N = 100k, a rebuild every step) and bh_4m on the one card
# without drift or selfcheck.  label: (arguments, seconds allowed)
BENCH_RUNS = {
    "v5_bench": ([], 600),
    "v5_bench k1 n100k": (["--k", "1", "--n", "100000", "--skip-drift",
                           "--skip-selfcheck"], 300),
    "bh_4m": (["--preset", "bh_4m", "--skip-drift", "--skip-selfcheck"],
              400),
}
BENCH_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "value_spread", "gflops",
    "gflops_useful", "mfu", "near_lane_occupancy", "overflow_bands",
    "overflow_cells", "overflow_g2_graceful", "overflow", "launches",
    "peak_memory_bytes")
BENCH_DRIFT_FIELDS = ("drift", "drift_steps", "drift_ok", "value_hot",
                      "value_avg_1k")
BENCH_SELFCHECK_FIELDS = tuple(f"selfcheck_{k}{s}" for s in ("", "_t128")
                               for k in ("far", "mid", "near"))


def bench_phase(runner_drift):
    """`python -m nbody_tpu_torch.bench` in a process of its own for each
    of BENCH_RUNS: its stderr logged, its one stdout line parsed and
    checked for every field, its launches for every force kernel; the
    full v5_bench run's drift must print as [runner]'s (both are
    drift_protocol from the same IC in chunks of 32).  Returns {label:
    the parsed line}."""
    torch.cuda.empty_cache()
    out = {}
    for label, (extra, timeout) in BENCH_RUNS.items():
        cmd = [sys.executable, "-m", "nbody_tpu_torch.bench"] + extra
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        secs = time.perf_counter() - t0
        for line in done.stderr.splitlines():
            log(f"[bench {label} stderr] {line}")
        lines = done.stdout.splitlines()
        if done.returncode != 0 or len(lines) != 1:
            raise RuntimeError(f"[bench {label}] exited {done.returncode} "
                               f"with {len(lines)} stdout lines")
        res = json.loads(lines[0])
        want = BENCH_FIELDS
        if not extra:
            want += BENCH_DRIFT_FIELDS + BENCH_SELFCHECK_FIELDS
        missing = [k for k in want if k not in res]
        if missing:
            raise RuntimeError(f"[bench {label}] lacks {missing}")
        log(f"[bench {label}] peak memory "
            f"{res['peak_memory_bytes'] / 2**30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated); {secs:.1f} s")
        log(f"[bench {label}] {lines[0]}")
        check_launches(f"bench {label}", res["launches"])
        out[label] = res
    got, want = (f"{x:.6e}" for x in (out["v5_bench"]["drift"],
                                      runner_drift))
    log(f"[bench] drift {got}, [runner]'s {want}")
    if got != want:
        raise RuntimeError(f"the bench's drift {got} is not [runner]'s "
                           f"{want}")
    return out


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
    log(f"[build] the far and table sweeps' one-SFU 1/sqrt differs from "
        f"IEEE sqrt and division at {bad} floats of [2^-100, inf) (at most "
        f"{kern.INV_SQRT_TIES}: two per odd binade)")
    if bad > kern.INV_SQRT_TIES:
        raise RuntimeError(f"inv_sqrt_rn: {bad} mismatches")

    base = PRESETS["v5_bench"]
    geo = {
        "t512": check_geometry("n=50k t512", base.replace(n=50_000)),
        "t128": check_geometry("n=50k t128 near_cap=60", base.replace(
            n=50_000, force_tile=128, near_cap=60)),
    }
    geo_err = {k: v[0] for k, v in geo.items()}
    edges_differ = far_edges_phase(base)

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
    launches, runner_err, runner_ms, runner_differ, gate = runner_phase(
        cfg, RUNNER_STEPS)
    launches_tools, (tools_kern, tools_differ), tools_res = tools_phase(
        cfg, gate["state"], gate["drift_steps"], gate["e1"])

    calls = kernel_calls(cfg, ps, ms, ss, bands, tables)
    errs, main_differ = compare(calls, "kernels main", (ps, ss, cfg))
    bnd = bounds_ms(cfg, ps, ss, bands, tables)
    rows = []
    for k, (kfn, pfn) in calls.items():
        rel, abs_err = errs[k]
        if not rel <= BOUNDS[k]:
            raise RuntimeError(f"{k} at the main path: error {rel} > "
                               f"{BOUNDS[k]}")
        k_ms, p_ms = event_ms(kfn, 20), event_ms(pfn, 2)
        rows.append({
            "name": k, "path": "main", "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[k][0], "bound_by": bnd[k][1], "library_ms": None,
            "ms_runner": runner_ms[k][0], "bound_ms_runner": runner_ms[k][1],
            "ms_tools": tools_kern[k][2], "bound_ms_tools": tools_kern[k][3],
            "rel_err_main": rel, "rel_err_runner": runner_err[k][0],
            "rel_err_tools": tools_kern[k][0],
            "rel_err_t512": geo_err["t512"][k],
            "rel_err_t128": geo_err["t128"][k],
            "launches_step": launches_step[k],
            "launches_per_step": launches_step[k] / len(step_ms),
        })
        log(f"[kernels main] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bnd[k][0]:.3f} ms ({bnd[k][1]}, "
            f"{100 * bnd[k][0] / k_ms:.1f}% of it reached), rel_err {rel:.3e}"
            + ceiling_note(k, bnd[k][2], k_ms))
        if k == "far_sweep":
            rows[-1].update(bit_differ_main=main_differ,
                            bit_differ_runner=runner_differ,
                            bit_differ_tools=tools_differ,
                            bit_differ_t512=geo["t512"][1],
                            bit_differ_t128=geo["t128"][1],
                            bit_differ_edges=edges_differ)
            far_ceiling_report("main", k_ms, bnd[k][0], bnd[k][2],
                               PR6_FAR_MS["main"])

    tile_order_report("kernels main", bands, tables)

    rows += probe_phase()

    # the initial conditions with no device named: CUDA by default
    ic = make_initial_state(cfg)
    if ic.pos.device.type != "cuda":
        raise RuntimeError(f"make_initial_state defaulted to {ic.device}")
    ref = reference_phase(cfg, ic)
    cli_res = cli_phase()
    vcfg, vstate, render_res = render_phase()
    view_res = view_phase(vcfg, vstate)
    del vstate
    ens_res = ensemble_phase()
    torch.cuda.empty_cache()
    shard_rows, shard_res = shard_phase()
    bench_res = bench_phase(gate["drift"])
    for row in rows[:3]:
        k = row["name"]
        row.update(launches_bench=bench_res["v5_bench"]["launches"][k],
                   launches_tools=launches_tools[k],
                   launches_cli_run=cli_res["launches_run"][k],
                   launches_cli_bench=cli_res["launches_bench"][k],
                   launches_render=render_res["launches"][k],
                   launches_view=view_res["launches"][k],
                   launches_ensemble=ens_res["launches"][k])
    rows += shard_rows
    log("[slice] " + json.dumps({
        "reference": ref,
        "cli": {k: v for k, v in cli_res.items()
                if not k.startswith("launches")},
        "render_ms": {m: render_res[f"{m}_ms"] for m in RENDER_BOUNDS},
        "view": {k: v for k, v in view_res.items() if k != "launches"},
        "ensemble_ms": ens_res["ms"], "shard": shard_res,
        "tools": tools_res, "bench": bench_res}))

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
