"""Band-cap demand (per-tile maxima under huge caps) at the initial
conditions and at a late state, with and without the adaptive skins
(port of tools/_prof_capdemand.py): the measurement that set the cap
defaults so the shipping run does not overflow.

    python -m nbody_tpu_torch.tools.prof_capdemand [advance_steps] [N]
                                                   [--device cuda]

The tool's own config is SimConfig(n, theta=0.5, rebuild_every=16,
hold_farmid=4, check_overflow=False): unlike v5_bench it has force_tile
256 and super-supers (no_ss off).  Demand is measured under BIG caps
(g2_cap_factor at its structural maximum, 8: an overflowed grandchild
cap forces children into the near band and would show as near demand);
the skins are adaptive_drift's envelopes for rebuild_every steps, which
is what the runner's first rebuild of a run_scan call that starts
again (on a state it did not hand out) gives.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation, adaptive_drift
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

BIG = dict(sup_cap=2048, mid_cap=1024, cmid_cap=2048, near_cap=2048,
           g2_cap_factor=8)
BANDS = ("sup", "mid", "cmid", "near", "wins")


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=16,
                     hold_farmid=4, check_overflow=False)


def demand(state: ParticleState, cfg: SimConfig, skins: bool = True) -> dict:
    """Per-tile band counts' mean/p999/max of one build at `state` under
    cfg's caps (pass cfg.replace(**BIG) for demand), with adaptive_drift
    skins for cfg.rebuild_every steps or none, plus the grandchild-cap
    flag and the cell, child and grandchild counts."""
    ps, ms, cs, perm, _, size = common.sorted_padded(state, cfg)
    if skins:
        npad = ps.shape[0]
        v = common.norms_padded(state.vel[perm], npad)
        a = common.norms_padded(state.acc[perm], npad)
        d = adaptive_drift(v, a, cs, size, cfg)
    else:
        d = torch.zeros(ps.shape[0], device=ps.device)
    cells, _, bands, _ = forces.build_bands(ps, ms, cs, cfg, drift=d)
    out = common.band_quantiles(bands, BANDS)
    out.update(g2_overflow=bool(cells.overflow_g2),
               n_cells=int(cells.n_cells), n_child=int(cells.n_child),
               n_g2=int(cells.n_g2))
    return out


def report(label: str, r: dict) -> str:
    return (f"[{label}] {common.quantile_text(BANDS, r)}  "
            f"g2over={r['g2_overflow']} cells={r['n_cells']} "
            f"child={r['n_child']} g2={r['n_g2']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=1024)
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    big = cfg.replace(**BIG)
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    for label, skins in (("IC skins", True), ("IC live ", False)):
        print(report(label, demand(state, big, skins)), flush=True)
    state = common.advance(sim, state, args.steps // 128 * 128, 128,
                           lambda m: print(m, flush=True))
    for label, skins in (("hot skins", True), ("hot live ", False)):
        print(report(label, demand(state, big, skins)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
