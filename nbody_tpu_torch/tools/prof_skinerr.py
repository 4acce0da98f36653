"""Skin-induced force error against the build horizon K at a hot state
(port of tools/_prof_skinerr.py): bands built with K-step skins for K in
{1, 2, 4, 8, 16}, evaluated at once (j = 0) and held against the build
without skins.

    python -m nbody_tpu_torch.tools.prof_skinerr [--hot-state PATH | IC]
                                                 [--n N] [--device cuda]

The JAX tool reads the state that _prof_stale.py cached; this one reads
--hot-state (default: prof_mkhot's checkpoint; IC: the initial
conditions at --n).  Its config is SimConfig(n, theta=0.5,
check_overflow=False) (force_tile 256, super-supers on: not v5_bench);
it sorts on 30-bit codes (encode30 + morton_sort), so its builds run at
morton_bits=30, with the tool's skin min(v dt K safety, max_speed dt K).
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools.prof_latestate import sorted30
from nbody_tpu_torch.tools.prof_stale import core_of, rel_stats

KS = (1, 2, 4, 8, 16)


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, check_overflow=False)


def skin_error(state: ParticleState, cfg: SimConfig, ks=KS) -> dict:
    """{K: {error stats, "wins", "near" (mean per tile), "overflow"}}."""
    n = state.n
    cfg30 = cfg.replace(morton_bits=30)
    ps, ms, cs, perm, _, size = sorted30(state, cfg.force_tile)
    v = torch.sqrt((common.clone_padded(state.vel[perm], ps.shape[0]) ** 2)
                   .sum(dim=1))
    core, _, _ = core_of(cs, size, cfg, n)

    def forces_with(drift):
        _, su, bd, tb = forces.build_bands(ps, ms, cs, cfg30, drift=drift)
        return forces.apply_bands(ps, ms, su, bd, tb, cfg)[:n], bd

    a_ref = forces_with(torch.zeros_like(v))[0].cpu().numpy()
    out = {}
    for k in ks:
        a, bd = forces_with(common.capped_drift(v, cfg, k))
        r = rel_stats(a.cpu().numpy(), a_ref, core)
        r.update(wins=float(bd.win_cnt.float().mean()),
                 near=float(bd.near_cnt.float().mean()),
                 overflow={f: bool(getattr(bd, f"{f}_overflow"))
                           for f in ("near", "sup", "mid", "cmid")})
        out[k] = r
    return out


def report(k: int, r: dict) -> str:
    o = r["overflow"]
    return (f"K={k:2d}: med {r['med']:.2e} p95 {r['p95']:.2e} core med "
            f"{r['core_med']:.2e} p95 {r['core_p95']:.2e} | wins "
            f"{r['wins']:.0f} near {r['near']:.0f} over n={o['near']} "
            f"s={o['sup']} m={o['mid']} c={o['cmid']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hot-state", default=common.HOT_STATE)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="bodies of the IC (with --hot-state IC)")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    state, _ = common.load_state(args.hot_state, args.n, dev)
    for k, r in skin_error(state, make_config(state.n)).items():
        print(report(k, r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
