"""Anatomy of the tiles with the highest band demand (port of
tools/_prof_tailtargets.py): are the worst tiles Morton-seam blocks (fat
sub-spheres from runs that straddle octant boundaries) or busy tiles of
the dense core?

    python -m nbody_tpu_torch.tools.prof_tailtargets [N] [--device cuda]

The tool's own config is SimConfig(n, theta=0.5, check_overflow=False)
(force_tile 256, super-supers on: not v5_bench), built under the same
huge caps as prof_capdemand and with no skins, at the initial
conditions.  The top tiles of each band are ordered by falling count,
ties by tile index (a stable sort; the JAX tool's numpy argsort leaves
their order open).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools.prof_capdemand import BIG


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, check_overflow=False)


def tail(state: ParticleState, cfg: SimConfig, top: int = 8) -> dict:
    """Sub-sphere radii, the `top` tiles of the near, sup and mid bands
    and the share of fat-sphere (radius > box/16) tiles, of one build
    under cfg's caps (pass cfg.replace(**BIG) for demand)."""
    ps, ms, cs, _, _, size = common.sorted_padded(state, cfg)
    _, _, bands, _ = forces.build_bands(ps, ms, cs, cfg)
    subs = forces.target_subspheres(ps, cfg.force_tile, codes=cs,
                                    bits=cfg.morton_bits)
    rad = subs.radius.reshape(-1, forces.SUB_FACTOR).cpu().numpy()
    sup, mid, near, wins = (x.cpu().numpy() for x in (
        bands.sup_cnt, bands.mid_cnt, bands.near_cnt, bands.win_cnt))
    size = float(size)
    rmax = rad.max(axis=1)
    tops = {}
    for label, arr in (("near", near), ("sup", sup), ("mid", mid)):
        tops[label] = [
            {"t": int(t), "sup": int(sup[t]), "mid": int(mid[t]),
             "near": int(near[t]), "wins": int(wins[t]),
             "subrad": np.sort(rad[t])[::-1][:4].tolist()}
            for t in np.argsort(-arr, kind="stable")[:top]]
    fat = rmax > size / 16
    return {
        "size": size,
        "rad_p50": float(np.percentile(rmax, 50)),
        "rad_p99": float(np.percentile(rmax, 99)),
        "rad_max": float(rad.max()),
        "top": tops,
        "fat": int(fat.sum()),
        "fat_share": float(fat.mean()),
        "fat_near_p50": float(np.percentile(near[fat], 50)) if fat.any()
        else 0.0,
        "fat_near_max": int(near[fat].max()) if fat.any() else 0,
        "thin_near_p999": float(np.percentile(near[~fat], 99.9))
        if (~fat).any() else 0.0,
        "thin_near_max": int(near[~fat].max()) if (~fat).any() else 0,
    }


def report(r: dict) -> str:
    lines = [f"box size {r['size']:.0f}; percentiles of max sub-radius: "
             f"p50 {r['rad_p50']:.1f} p99 {r['rad_p99']:.1f} max "
             f"{r['rad_max']:.1f}"]
    for label, rows in r["top"].items():
        lines.append(f"top {label}:")
        lines += [f"  t={x['t']} sup={x['sup']} mid={x['mid']} "
                  f"near={x['near']} wins={x['wins']} "
                  f"subrad={np.round(x['subrad'], 1)}" for x in rows]
    lines.append(f"targets with a sub-sphere radius > box/16: {r['fat']} "
                 f"({r['fat_share']:.3%}); their near p50/max: "
                 f"{r['fat_near_p50']:.0f}/{r['fat_near_max']}")
    lines.append(f"non-fat targets near p999/max: "
                 f"{r['thin_near_p999']:.0f}/{r['thin_near_max']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    state = Simulation(cfg, device=dev).init_state()
    print(report(tail(state, cfg.replace(**BIG))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
