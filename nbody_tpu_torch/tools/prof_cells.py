"""Stage prefixes of the adaptive cell build (port of tools/_prof_cells.py):
which part of cells.build_source_cells costs the time at 1M?  Each stage
runs the real build up to and including that stage, so the deltas
between lines attribute its cost.

    python -m nbody_tpu_torch.tools.prof_cells [n] [--device cuda]

The tool's own config is SimConfig(n, check_overflow=False) (63-bit
codes, force_tile 256), from the initial conditions.  The stages, in the
JAX tool's names, and what each adds of the port's build:

  cut_scans    adjacent_lcp and _sliding_cut_depth
  flags        the three boundary flags (_boundary_flags; run_start by
               scatter_reduce where the JAX build takes a cummax)
  ids          _segment_ids of each level
  compacts     _compact_starts of each level at its cap (cells, children,
               grandchildren)
  moments      the _cumsum_prefix mass moments of every compacted run
               (float64 prefix sums, as _cells_from_runs takes them)
  analytic     each run's depth, width and cell_corner
  full_noskin  build_source_cells
  full_skin    build_source_cells with a uniform drift of 1.0

Each stage's time is the median of 6 calls after one (CUDA events around
each call on the card, the host clock on the CPU); beside it the aten
ops it dispatches, views left out (each one kernel launch or more).  The
JAX tool subtracts a relay time; that has no counterpart on the card.
The build reads nothing back from the device, so a stage's time is its
launches and its kernels.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import cells as C
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

STAGES = ("cut_scans", "flags", "ids", "compacts", "moments", "analytic",
          "full_noskin", "full_skin")


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, check_overflow=False)


def prefix(upto: str, ps, ms, cs, lo, size, cfg: SimConfig):
    """The build on sorted, tile-padded inputs up to stage `upto`; returns
    that stage's outputs: (cut depth,), the three levels' flags, segment
    ids or run edges [cap + 1], per-run moment sums [cap, 4] (mass, then
    mass x position), those plus (corner, width) per level, or the
    SourceCells."""
    b, bits = cfg.force_tile, cfg.morton_bits
    if upto.startswith("full"):
        drift = torch.ones_like(ms) if upto == "full_skin" else None
        return C.build_source_cells(cs, ps, ms, b, cfg.g, cfg.cell_capacity,
                                    lo, size, drift_sorted=drift,
                                    g2_factor=cfg.g2_cap_factor, bits=bits)
    n = cs.shape[0]
    max_d = C.max_depth_of(bits)
    g_cap = cfg.cell_capacity
    caps = (g_cap, 8 * g_cap, min(cfg.g2_cap_factor, 8) * 8 * g_cap)
    lcp = C.adjacent_lcp(cs, bits)
    cut = C._sliding_cut_depth(lcp, b, max_d)
    if upto == "cut_scans":
        return (cut,)
    flags = C._boundary_flags(lcp, cut, b, max_d)
    if upto == "flags":
        return flags
    ids = tuple(C._segment_ids(f) for f in flags)
    if upto == "ids":
        return ids
    edges = tuple(C._compact_starts(f, cap) for f, cap in zip(flags, caps))
    if upto == "compacts":
        return edges
    pmw = C._cumsum_prefix(torch.cat([ms[:, None], ps * ms[:, None]], 1))
    runs = []
    for e in edges:
        first = e[:-1]
        count = torch.clamp(e[1:] - first, 0, n)
        runs.append((torch.clamp(first, 0, n - 1), count))
    moments = tuple(pmw[torch.clamp(row + count, 0, n)] - pmw[row]
                    for row, count in runs)
    if upto == "moments":
        return moments
    geometry = []
    for level, (row, count) in enumerate(runs):
        depth = torch.clamp(cut[row] + level, max=max_d)
        width = size * torch.exp2(-depth.to(torch.float32))
        corner = C.cell_corner(cs[row], depth, lo, size, bits)
        geometry.append((torch.where((count > 0)[:, None], corner, 0.0),
                         width))
    return moments + tuple(geometry)


def stage_times(state: ParticleState, cfg: SimConfig, stages=STAGES,
                iters: int = 6) -> dict:
    """{"ms": {stage: median ms}, "ops": {stage: aten ops dispatched,
    views left out (common.op_count)}, "n_cells", "n": rows}."""
    ps, ms, cs, _, lo, size = common.sorted_padded(state, cfg)
    times, ops = {}, {}
    for s in stages:
        def fn(s=s):
            return prefix(s, ps, ms, cs, lo, size, cfg)

        times[s] = common.device_times(fn, state.device, iters)["median_ms"]
        ops[s] = common.op_count(fn)
    cells = prefix("full_noskin", ps, ms, cs, lo, size, cfg)
    return {"ms": times, "ops": ops, "n_cells": int(cells.n_cells),
            "n": ps.shape[0]}


def report(r: dict) -> str:
    return "\n".join(f"{k:12s} {v:8.2f} ms  {r['ops'][k]:5d} ops"
                     for k, v in r["ms"].items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    state = Simulation(cfg, device=dev).init_state()
    r = stage_times(state, cfg)
    print(f"[cells] n={args.n}: {r['n_cells']} cells ({dev.type})",
          flush=True)
    print(report(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
