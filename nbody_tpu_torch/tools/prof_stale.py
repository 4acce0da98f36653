"""Force error of band reuse at a late state (port of
tools/_prof_stale.py): structures built once at S0 with K-step skins,
then, after j in {2, 4, 8, 16} per-step-rebuild steps of the state,
  frozen   the S0 structures with live targets and a live near band;
  refresh  the S0 cut and classification with every source moment
           recomputed from live positions (forces.refresh_farmid, the
           runner's refresh_moments path) plus the live near band;
each against a fresh per-step build (compute_bh_acc), split by the core
(the 10% of bodies with the smallest local cell width) and the rest.

    python -m nbody_tpu_torch.tools.prof_stale [advance] [N] [--device cuda]

The tool's own config is SimConfig(n, theta=0.5, rebuild_every=8,
hold_farmid=1, adaptive_rebuild=False, check_overflow=False) (force_tile
256, super-supers on: not v5_bench), K = 16.  S0 sorts on 30-bit codes
(encode30 + morton_sort), so its builds run at morton_bits=30; the
fresh builds and the steps keep the config's 63.  The JAX tool's
refresh rebuilds the cells with build_source_cells's default grandchild
cap (8) where the runner uses cfg.g2_cap_factor; this port runs the
runner's refresh.  The advanced state is not cached on disk.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation, compute_bh_acc
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools.prof_latestate import sorted30

K = 16
JS = (2, 4, 8, 16)


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=8,
                     hold_farmid=1, adaptive_rebuild=False,
                     check_overflow=False)


def core_of(cs: torch.Tensor, size, cfg: SimConfig, n: int) -> np.ndarray:
    """The bodies (in sorted order) whose 30-bit local cell width is
    under its 10th percentile, and that width's medians."""
    w = forces.local_width(cs, size, cfg.force_tile, 30).cpu().numpy()[:n]
    core = w < np.percentile(w, 10)
    return core, float(np.median(w[core])), float(np.median(w))


def rel_stats(a: np.ndarray, a_true: np.ndarray, core: np.ndarray) -> dict:
    rel = (np.linalg.norm(a - a_true, axis=1)
           / (np.linalg.norm(a_true, axis=1) + 1e-6))
    return {"med": float(np.median(rel)), "p95": float(np.percentile(rel, 95)),
            "max": float(rel.max()), "core_med": float(np.median(rel[core])),
            "core_p95": float(np.percentile(rel[core], 95))}


def stale(state: ParticleState, cfg: SimConfig, js=JS, k: int = K) -> dict:
    """{"core_width", "width", "j": {j: {"frozen": stats, "refresh":
    stats}}}."""
    n = state.n
    cfg30 = cfg.replace(morton_bits=30)
    ps0, ms, cs, perm, lo, size = sorted30(state, cfg.force_tile)
    npad = ps0.shape[0]
    v = torch.sqrt((common.clone_padded(state.vel[perm], npad) ** 2)
                   .sum(dim=1))
    drift = common.capped_drift(v, cfg, k)
    _, supers0, bands0, tables0 = forces.build_bands(ps0, ms, cs, cfg30,
                                                     drift=drift)
    core, w_core, w_all = core_of(cs, size, cfg, n)
    sim = Simulation(cfg, device=state.device)
    out = {"core_width": w_core, "width": w_all, "j": {}}
    st, done = state, 0
    for j in js:
        while done < j:
            st = sim.step(st)
            done += 1
        p_live = common.clone_padded(st.pos[perm], npad)
        a_frozen = forces.apply_bands(p_live, ms, supers0, bands0, tables0,
                                      cfg)
        a_refresh = forces.refresh_farmid(
            p_live, ms, cs, drift, lo, size, bands0, cfg30) + \
            forces.apply_near(p_live, p_live, ms, bands0, cfg)
        a_true = compute_bh_acc(st.pos, st.mass, cfg)[perm].cpu().numpy()
        out["j"][j] = {
            name: rel_stats(a[:n].cpu().numpy(), a_true, core)
            for name, a in (("frozen", a_frozen), ("refresh", a_refresh))}
    return out


def report(r: dict) -> str:
    lines = [f"core w_loc median {r['core_width']:.1f} vs all "
             f"{r['width']:.1f}"]
    for j, by in r["j"].items():
        for label, s in by.items():
            lines.append(
                f"  j={j:2d} {label:8s} rel err: med {s['med']:.2e} "
                f"p95 {s['p95']:.2e} max {s['max']:.2e} | core med "
                f"{s['core_med']:.2e} p95 {s['core_p95']:.2e}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("advance", nargs="?", type=int, default=512)
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    sim = Simulation(cfg, device=dev)
    state = common.advance(sim, sim.init_state(), args.advance // 128 * 128,
                           128, lambda m: print(m, flush=True))
    print(report(stale(state, cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
