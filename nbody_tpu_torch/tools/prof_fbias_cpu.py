"""Force-accuracy scan of the production band path against a float64
direct sum (port of tools/_prof_fbias_cpu.py, the small-N twin of
prof_fbias): the disk-galaxy IC of v5_bench at n bodies, and for each
variant (θ, force_tile, no_ss) the relative error's mean and q50/q90/q99
and its mean over the weak-|a| half (the halo) and the strong half.

    python -m nbody_tpu_torch.tools.prof_fbias_cpu [n] [--device cuda]

The JAX tool runs on the CPU only; this one runs where --device says
(the hand kernels on CUDA, their plain versions on the CPU).  The
reference is a float64 sum over every pair (common.direct_sum, on the
same device).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

VARIANTS = ({}, {"theta": 0.3}, {"theta": 0.2}, {"force_tile": 256},
            {"no_ss": True}, {"no_ss": True, "theta": 0.3},
            {"force_tile": 256, "no_ss": True})


def make_config(n: int = 20_000) -> SimConfig:
    return PRESETS["v5_bench"].replace(n=n, check_overflow=False)


def direct_f64(state: ParticleState, cfg: SimConfig) -> np.ndarray:
    """float64 accelerations of every body from every body (as numpy)."""
    return common.direct_sum(state, cfg, dtype=torch.float64).cpu().numpy()


def scan(state: ParticleState, cfg: SimConfig, variants=VARIANTS,
         a_true: np.ndarray | None = None) -> list:
    """One dict of error statistics for each variant (cfg overrides)."""
    n = state.n
    if a_true is None:
        a_true = direct_f64(state, cfg)
    out = []
    for ov in variants:
        c = cfg.replace(**ov)
        ps, ms, cs, perm, _, _ = common.sorted_padded(state, c)
        a_prod = forces.bh_forces_grouped(ps, ms, cs, c)[:n]
        at = a_true[perm.cpu().numpy()]
        den = np.linalg.norm(at, axis=1) + 1e-12
        rel = np.linalg.norm(a_prod.cpu().numpy() - at, axis=1) / den
        q = np.percentile(rel, [50, 90, 99])
        halo = den <= np.percentile(den, 50)
        out.append({"variant": dict(ov), "rel_mean": float(rel.mean()),
                    "q50": float(q[0]), "q90": float(q[1]),
                    "q99": float(q[2]),
                    "halo_mean": float(rel[halo].mean()),
                    "core_mean": float(rel[~halo].mean())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=20_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    state = Simulation(cfg, device=dev).init_state()
    a_true = direct_f64(state, cfg)
    print(f"n={args.n} fp64 direct done", flush=True)
    for r in scan(state, cfg, a_true=a_true):
        print(f"[{r['variant'] or 'ship'}] rel_mean={r['rel_mean']:.2e} "
              f"q50={r['q50']:.2e} q90={r['q90']:.2e} q99={r['q99']:.2e} "
              f"halo_mean={r['halo_mean']:.2e} "
              f"core_mean={r['core_mean']:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
