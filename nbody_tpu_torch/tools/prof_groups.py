"""Sub-phase times of the band build (port of tools/_prof_groups.py):
cells, supers, super-supers, target sub-spheres, band lists and tables,
each timed alone on its own inputs.

    python -m nbody_tpu_torch.tools.prof_groups [n] [--device cuda]

The tool's own config is SimConfig(n, check_overflow=False) with
morton_bits=30 (the JAX tool sorts on morton.encode30), from the initial
conditions, with a uniform drift of 10.0 on every body.  As in the JAX
tool the cells take the default grandchild factor (8, not
cfg.g2_cap_factor), the super-supers are forces.make_supersupers and the
sub-spheres split each tile at fixed b/8 strides (no codes).  Each phase
prints the median and the minimum of 6 calls after one (CUDA events
around each call on the card, the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

DRIFT = 10.0
BANDS = ("ss", "sup", "mid", "cmid", "near", "wins")


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, check_overflow=False, morton_bits=30)


def phases(state: ParticleState, cfg: SimConfig, iters: int = 6) -> dict:
    """{"ms": {phase: {"median_ms", "min_ms"}}, "n_cells", "tiles",
    "band_sums": {band: live entries summed over tiles}}."""
    dev = state.device
    b = cfg.force_tile
    ps, ms, cs, _, lo, size = common.sorted_padded(state, cfg)
    drift = torch.full((ps.shape[0],), DRIFT, device=dev)
    out, times = {}, {}

    def run(label, fn):
        out[label] = fn()
        times[label] = common.device_times(fn, dev, iters)

    run("cells", lambda: build_source_cells(
        cs, ps, ms, b, cfg.g, cfg.cell_capacity, lo, size,
        drift_sorted=drift, bits=cfg.morton_bits))
    run("supers", lambda: forces.make_supers(out["cells"]))
    run("supersupers", lambda: forces.make_supersupers(out["supers"]))
    run("subspheres", lambda: forces.target_subspheres(ps, b, drift=drift))
    run("band_lists", lambda: forces.cell_band_lists(
        out["subspheres"], out["supersupers"], out["supers"], out["cells"],
        cfg))
    run("tables", lambda: forces.build_cell_tables(
        out["cells"], out["supers"], out["supersupers"], out["band_lists"],
        cfg))
    bands = out["band_lists"]
    return {"ms": times, "n_cells": int(out["cells"].n_cells),
            "tiles": bands.win_cnt.shape[0],
            "band_sums": {k: int(getattr(bands, common.COUNTS[k]).sum())
                          for k in BANDS}}


def report(r: dict) -> str:
    return "\n".join(f"{k:12s} {t['median_ms']:8.2f} ms (min "
                     f"{t['min_ms']:.2f})" for k, t in r["ms"].items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    r = phases(Simulation(cfg, device=dev).init_state(), cfg)
    print(f"[groups] n={args.n}: {r['n_cells']} cells, bands per tile "
          + " ".join(f"{k}={s / r['tiles']:.1f}"
                     for k, s in r["band_sums"].items())
          + f" ({dev.type})", flush=True)
    print(report(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
