"""Hot-state skin-width-cap (α) experiment (port of
tools/_prof_hotcfg.py).  For each α, at the hot checkpoint:
  1. band-cap demand under huge caps with the adaptive skins of the
     runner's first rebuild (k_env = 16), and the validity horizon those
     skins buy;
  2. the sustained rate of the adaptive runner with that α and caps
     sized to the demand (prof_hotrate.sustained with one timed call).
Gate a winner with prof_kilostep.

    python -m nbody_tpu_torch.tools.prof_hotcfg [alphas, e.g. 0.75,1.5,2.5]
                                                [hot.npz] [--device cuda]

The tool's own config is SimConfig(n, theta=0.5, rebuild_every=16,
hold_farmid=8, check_overflow=False) (force_tile 256, super-supers on:
not v5_bench).
"""

from __future__ import annotations

import argparse
import sys

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import adaptive_drift, \
    validity_horizon
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools.prof_hotrate import sustained
from nbody_tpu_torch.utils.io import load_checkpoint

HUGE = dict(ss_cap=1024, sup_cap=2048, mid_cap=1024, cmid_cap=2048,
            near_cap=2048, g2_cap_factor=8)
BANDS = ("ss", "sup", "mid", "cmid", "near", "wins")


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=16,
                     hold_farmid=8, check_overflow=False)


def demand(state: ParticleState, cfg: SimConfig) -> dict:
    """Per-tile band counts' mean/p999/max of one build with
    adaptive_drift skins at k = 16 under cfg's caps, the validity horizon
    of those skins and the cell count."""
    ps, ms, cs, perm, _, size = common.sorted_padded(state, cfg)
    npad = ps.shape[0]
    v = common.norms_padded(state.vel[perm], npad)
    a = common.norms_padded(state.acc[perm], npad)
    d = adaptive_drift(v, a, cs, size, cfg, k=16.0)
    cells, _, bands, _ = forces.build_bands(ps, ms, cs, cfg, drift=d)
    out = common.band_quantiles(bands, BANDS)
    out.update(s_valid=int(validity_horizon(v, a, d, cfg)),
               n_cells=int(cells.n_cells))
    return out


def cap_of(q: dict, align: int = 64) -> int:
    """The demand's maximum with 25% + 16 headroom, rounded up to align."""
    return -(-int(q["max"] * 1.25 + 16) // align) * align


def caps_for(dem: dict) -> dict:
    return dict(ss_cap=min(cap_of(dem["ss"]), 1024),
                sup_cap=cap_of(dem["sup"]), mid_cap=cap_of(dem["mid"]),
                cmid_cap=cap_of(dem["cmid"]),
                near_cap=cap_of(dem["near"], align=128),
                win_cap=max(512, cap_of(dem["wins"])))


def alpha_run(state: ParticleState, base: SimConfig, alpha: float,
              steps: int = 64) -> dict:
    """{"demand", "caps", "table_gb", "rate"} of one α."""
    dem = demand(state, base.replace(**HUGE, skin_width_cap=alpha))
    caps = caps_for(dem)
    cfg = base.replace(skin_width_cap=alpha, **caps)
    rate = sustained(state, cfg, steps=steps, reps=1)
    rate.pop("state")
    return {"demand": dem, "caps": caps,
            "table_gb": cfg.table_bytes / 2**30, "rate": rate}


def report(alpha: float, r: dict) -> str:
    d, rate = r["demand"], r["rate"]
    return (f"[alpha={alpha}]\n  demand: {common.quantile_text(BANDS, d)}  "
            f"s_valid={d['s_valid']} cells={d['n_cells']}\n"
            f"  caps: {r['caps']}  table_gb={r['table_gb']:.2f}\n"
            f"  sustained hot: {rate['ms_per_step']:.2f} ms/step "
            f"({rate['steps_per_sec']:.2f} steps/s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("alphas", nargs="?", default="0.75,1.5,2.5")
    ap.add_argument("hot", nargs="?", default=common.HOT_STATE)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    state, at_step = load_checkpoint(args.hot, device=dev)
    print(f"[hotcfg] {args.hot} (step {at_step}) n={state.n}", flush=True)
    base = make_config(state.n)
    for alpha in (float(x) for x in args.alphas.split(",")):
        print(report(alpha, alpha_run(state, base, alpha)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
