"""Band counts and overflow flags at a late state (dense contracted
core) under reuse skins for K in {1, 8, 16, 32} steps (port of
tools/_prof_latestate.py): do large-K skins push the core past the band
caps (overflow: a coarse-monopole fallback, a standing θ violation)?

    python -m nbody_tpu_torch.tools.prof_latestate [advance_steps] [N]
                                                   [--device cuda]

The tool's own config is SimConfig(n, theta=0.5, rebuild_every=8,
hold_farmid=4, check_overflow=False) (force_tile 256, super-supers on:
not v5_bench).  It sorts on 30-bit codes (morton.encode30 +
morton_sort, stable as lax.sort_key_val is), so its builds run at
morton_bits=30, and its skin is the tool's own formula, min(v dt K
safety, max_speed dt K), zero at K=1 (not adaptive_drift).  Besides the
counts: the share of tiles at the near cap and at the window cap.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import bbox, forces, morton
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

KS = (1, 8, 16, 32)
BANDS = ("sup", "mid", "cmid", "near", "wins")


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=8,
                     hold_farmid=4, check_overflow=False)


def sorted30(state: ParticleState, b: int):
    """(ps, ms, cs, perm, lo, size) on 30-bit codes, tile-padded."""
    lo, size = bbox.bounding_cube(state.pos)
    cs, perm = morton.morton_sort(morton.encode30(state.pos, lo, size))
    ps, ms, cs = forces.pad_sorted(state.pos[perm], state.mass[perm], cs, b)
    return ps, ms, cs, perm, lo, size


def late_state(state: ParticleState, cfg: SimConfig, ks=KS) -> dict:
    """{K: {band: {"mean", "max"}, "overflow": {...}, "near_at_cap",
    "win_at_cap"}} for each K of `ks`."""
    cfg30 = cfg.replace(morton_bits=30)
    ps, ms, cs, perm, _, _ = sorted30(state, cfg.force_tile)
    v = common.norms_padded(state.vel[perm], ps.shape[0])
    out = {}
    for k in ks:
        drift = (torch.zeros_like(v) if k == 1
                 else common.capped_drift(v, cfg, k))
        _, _, bands, _ = forces.build_bands(ps, ms, cs, cfg30, drift=drift)
        r = {b: {"mean": float(getattr(bands, common.COUNTS[b]).float()
                               .mean()),
                 "max": int(getattr(bands, common.COUNTS[b]).max())}
             for b in BANDS}
        r["overflow"] = {f: bool(getattr(bands, f"{f}_overflow"))
                         for f in ("sup", "mid", "cmid", "near")}
        r["near_at_cap"] = float((bands.near_cnt >= cfg.near_cap)
                                 .float().mean())
        r["win_at_cap"] = float((bands.win_cnt >= bands.win_first.shape[1])
                                .float().mean())
        out[k] = r
    return out


def report(k: int, r: dict) -> str:
    o = r["overflow"]
    return (f"K={k:2d}: " + " ".join(
        f"{b} {r[b]['mean']:6.1f}/{r[b]['max']:4d}" for b in BANDS)
        + f" over: s={o['sup']} m={o['mid']} c={o['cmid']} n={o['near']}\n"
        f"      targets at near cap: {r['near_at_cap']:.3%}  at window "
        f"cap: {r['win_at_cap']:.3%}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=512)
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    sim = Simulation(cfg, device=dev)
    state = common.advance(sim, sim.init_state(), args.steps // 128 * 128,
                           128, lambda m: print(m, flush=True))
    for k, r in late_state(state, cfg).items():
        print(report(k, r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
