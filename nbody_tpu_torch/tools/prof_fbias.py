"""Force-bias power probe at a hot (contracted-core) state, the quick
bisect for secular energy drift (port of tools/_prof_fbias.py).

For each override variant of the shipping preset, one band build at the
state and the power its force error injects:

    P_err = sum_i m_i v_i . (a_prod,i - a_direct,i)

P_err dt 128 / |E| predicts the drift over 128 steps that the kilostep
gate would see.  Also the relative force error (mean, max, q50/q90/q99),
the core (top decile of |a_direct|) against the halo, the MAX_SPEED
clamp's kinetic-energy removal over one step, the seven overflow flags
and the cell count.

    python -m nbody_tpu_torch.tools.prof_fbias [variant ...]
        [--hot-state chip_scratch/hot1m.npz | IC] [--n 1000000]
        [--device cuda]

Each variant is a "k=v,k=v" override string of PRESETS["v5_bench"]
(check_overflow=False); "" (the default) is the shipping structure.
--hot-state is NBODY_HOT_STATE (IC: the initial conditions at --n,
NBODY_N).  The reference is ops/forces.direct_forces in float32 panels
(plain PyTorch, as the JAX tool's is XLA); its time is printed.  The
statistics run over every body, or over the bodies `rows` when given
(P_err then also scaled by n / len(rows)).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils import metrics
from nbody_tpu_torch.utils.profiling import _sync

def make_config(n: int) -> SimConfig:
    return PRESETS["v5_bench"].replace(n=n, check_overflow=False)


def direct_reference(state: ParticleState, cfg: SimConfig,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """float32 direct-sum accelerations of every body (or of `rows`)
    from every body, in forces.direct_forces's panels."""
    return common.direct_sum(state, cfg, rows)


def probe(state: ParticleState, cfg: SimConfig, a_ref: torch.Tensor,
          e_tot: float, rows: torch.Tensor | None = None) -> dict:
    """The force error of cfg's band path at `state` against `a_ref`
    (direct accelerations of every body, or of `rows`)."""
    n = state.n
    ps, ms, cs, perm, _, _ = common.sorted_padded(state, cfg)
    cells, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    a_sorted = forces.apply_bands(ps, ms, ss, bands, tables, cfg)
    a_prod = torch.empty_like(state.pos)
    a_prod[perm] = a_sorted[:n]                 # the original order
    idx = slice(None) if rows is None else rows
    vs, m, ap = state.vel[idx], state.mass[idx], a_prod[idx]
    da = ap - a_ref
    power = m * (vs * da).sum(dim=1)
    den = torch.linalg.norm(a_ref, dim=1) + 1e-6
    rel = torch.linalg.norm(da, dim=1) / den
    core = den >= torch.quantile(den, 0.9)
    n_core = int(core.sum())
    q = torch.quantile(rel, torch.tensor([0.5, 0.9, 0.99],
                                         device=rel.device))
    # the MAX_SPEED clamp's KE removal over one step with this force
    sp = torch.linalg.norm(vs + ap * cfg.dt, dim=1)
    over = sp > cfg.max_speed
    ke = 0.5 * torch.where(over, m * (sp ** 2 - cfg.max_speed ** 2),
                           0.0).sum()
    p_err = float(power.sum())
    scale = n / power.shape[0]
    de = p_err * scale * cfg.dt * 128.0
    return {
        "rows": power.shape[0],
        "p_err": p_err,
        "p_err_scaled": p_err * scale,
        "p_abs": float(power.abs().sum()),
        "de_128": de,
        "drift_128": de / abs(e_tot),
        "rel_mean": float(rel.mean()),
        "rel_max": float(rel.max()),
        "n_clamp": int(over.sum()),
        "ke_clamp": float(ke) * scale,
        "overflow": common.overflow_flags(cells, bands),
        "n_cells": int(cells.n_cells),
        "p_core": float(power[core].sum()),
        "rel_core": float(rel[core].sum()) / n_core,
        "rel_halo": float(rel[~core].sum()) / (rel.shape[0] - n_core),
        "q50": float(q[0]), "q90": float(q[1]), "q99": float(q[2]),
    }


def report(label: str, r: dict, secs: float) -> str:
    ovf = [int(r["overflow"][k]) for k in common.FLAGS]
    return (f"[{label or 'ship'}] P_err={r['p_err_scaled']:+.4e} "
            f"dE/128steps={r['de_128']:+.4e} "
            f"(drift/128={r['drift_128']:+.2e}) "
            f"rel_mean={r['rel_mean']:.2e} rel_max={r['rel_max']:.2e} "
            f"clamped={r['n_clamp']} KEclamp/step={r['ke_clamp']:.3e} "
            f"ovf[ss,sup,mid,cmid,near,cells,g2]={ovf} "
            f"n_cells={r['n_cells']} ({secs:.0f}s)\n"
            f"    P_core(top-decile |a|)={r['p_core']:+.4e} "
            f"rel_core={r['rel_core']:.2e} rel_halo={r['rel_halo']:.2e} "
            f"rel_q50={r['q50']:.2e} q90={r['q90']:.2e} q99={r['q99']:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=[""])
    ap.add_argument("--hot-state", default=common.HOT_STATE)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="bodies of the IC (with --hot-state IC)")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    state, at_step = common.load_state(args.hot_state, args.n, dev)
    print(f"hot state {args.hot_state} (step {at_step}), n={state.n}",
          flush=True)
    base = make_config(state.n)
    t0 = time.perf_counter()
    a_ref = direct_reference(state, base)
    _sync(a_ref)
    print(f"direct O(N^2) reference: {time.perf_counter() - t0:.1f}s",
          flush=True)
    e_tot = float(metrics.total_energy(state, base))
    print(f"E = {e_tot:.6e}", flush=True)
    for ov in args.variants or [""]:
        cfg = base.replace(**common.parse_overrides(ov))
        t0 = time.perf_counter()
        r = probe(state, cfg, a_ref, e_tot)
        print(report(ov, r, time.perf_counter() - t0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
