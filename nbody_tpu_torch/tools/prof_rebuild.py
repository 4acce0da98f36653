"""The rebuild's phases (port of tools/_prof_rebuild.py): Morton sort,
the permutation gathers, cells, supers, super-supers, target
sub-spheres, classification and tables, each timed alone on its own
inputs, then the whole build_bands.

    python -m nbody_tpu_torch.tools.prof_rebuild [n] [advance_steps]
        [key=val ...] [--hot-state PATH] [--device cuda]

--hot-state is NBODY_HOT_STATE: the phases at that checkpoint instead of
the initial conditions advanced `advance_steps`.  The tool's own config
is SimConfig(n, rebuild_every=16, hold_farmid=4, check_overflow=False)
plus the overrides (force_tile 256, super-supers on: not v5_bench); the
skins are adaptive_drift's at k = 4.  Times are CUDA-event means on the
card (the host's median on the CPU); the JAX tool's relay subtraction
has no counterpart.  The rebuild reads nothing back from the device, so
each phase's time is its launches and its kernels.
"""

from __future__ import annotations

import argparse
import sys

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation, adaptive_drift, \
    sort_by_morton
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

BANDS = ("ss", "sup", "mid", "cmid", "near", "wins")


def make_config(n: int = 1_000_000, overrides: dict | None = None
                ) -> SimConfig:
    return SimConfig(n=n, rebuild_every=16, hold_farmid=4,
                     check_overflow=False).replace(**(overrides or {}))


def phases(state: ParticleState, cfg: SimConfig, iters: int = 8) -> dict:
    """{"ms": {phase: ms}, "n_cells", "band_sums": {band: live entries
    summed over tiles}, "tiles"}."""
    dev = state.device
    ms_by = {}

    def run(label, fn):
        ms_by[label] = common.device_ms(fn, dev, iters)
        return fn()

    pos, vel, mass, acc = state
    codes_s, perm, lo, size = run("sort", lambda: sort_by_morton(pos, cfg))
    pos_s, vel_s, mass_s, acc_s = run(
        "perm gathers", lambda: (pos[perm], vel[perm], mass[perm], acc[perm]))
    ps, msp, cs = forces.pad_sorted(pos_s, mass_s, codes_s, cfg.force_tile)
    npad = ps.shape[0]
    drift = adaptive_drift(common.norms_padded(vel_s, npad),
                           common.norms_padded(acc_s, npad),
                           cs, size, cfg, k=4.0)
    cells = run("cells", lambda: build_source_cells(
        cs, ps, msp, cfg.force_tile, cfg.g, cfg.cell_capacity, lo, size,
        drift_sorted=drift, g2_factor=cfg.g2_cap_factor,
        bits=cfg.morton_bits))
    supers = run("supers", lambda: forces.make_supers(cells))
    ss = run("supersupers", lambda: forces.make_ss(supers, cfg))
    tgt = run("subspheres", lambda: forces.target_subspheres(
        ps, cfg.force_tile, drift=drift, codes=cs, bits=cfg.morton_bits))
    bands = run("classify", lambda: forces.cell_band_lists(
        tgt, ss, supers, cells, cfg))
    run("tables", lambda: forces.build_cell_tables(cells, supers, ss, bands,
                                                   cfg))
    run("FULL build_bands", lambda: forces.build_bands(ps, msp, cs, cfg,
                                                       drift=drift))
    return {"ms": ms_by, "n_cells": int(cells.n_cells),
            "tiles": bands.win_cnt.shape[0],
            "band_sums": {b: int(getattr(bands, common.COUNTS[b]).sum())
                          for b in BANDS}}


def report(r: dict, device: str) -> str:
    lines = [f"  {k:18s} {v:7.1f} ms" for k, v in r["ms"].items()]
    lines.append("  bands: " + " ".join(
        f"{b}={s / r['tiles']:.1f}" for b, s in r["band_sums"].items())
        + f"  ({device})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("advance", nargs="?", type=int, default=0)
    ap.add_argument("overrides", nargs="*", help="key=val SimConfig fields")
    ap.add_argument("--hot-state", default="")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    if args.hot_state:
        state, at = common.load_state(args.hot_state, args.n, dev)
        print(f"  loaded {args.hot_state} (step {at})", flush=True)
    cfg = make_config(state.n if args.hot_state else args.n,
                      common.parse_overrides(args.overrides))
    sim = Simulation(cfg, device=dev)
    if not args.hot_state:
        state = common.advance(sim, sim.init_state(), args.advance, 256,
                               lambda m: print(m, flush=True))
    print(f"[rebuild phases] n={state.n} after {args.advance} steps",
          flush=True)
    print(report(phases(state, cfg), dev.type), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
