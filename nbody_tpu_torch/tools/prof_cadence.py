"""The adaptive runner's rebuild cadence and speed from the initial
conditions and from a hot state (port of tools/_prof_cadence.py).

    python -m nbody_tpu_torch.tools.prof_cadence [K] [R] [steps] [alpha]
        [--n N] [--hot-state PATH] [--device cuda]

The tool's own config is SimConfig(n, theta=0.5, rebuild_every=K,
hold_farmid=R, skin_width_cap=alpha, check_overflow=False) (force_tile
256, super-supers on), n = --n (the JAX tool fixes 1M).  For each state
make_adaptive_runner(cfg, steps, return_stats=True) runs once untimed,
and the timed call starts from that call's output, as the JAX tool's
does.  The port's runner carries its schedule on into that call (the
JAX tool's starts again at k_env = K), so the timed call's rebuilds are
those of steps [steps, 2 steps) of one long run.  Its time is the host
clock around the call and one device synchronisation.  --hot-state (default chip_scratch/hot1m.npz, written
by prof_mkhot, when that file exists) stands for the JAX tool's cached
/tmp/stale_state_1000000_512.npz; its cfg takes the state's n.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.models.simulation import make_adaptive_runner
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils.profiling import _sync


def make_config(k: int = 16, r: int = 4, alpha: float = 0.75,
                n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=k,
                     hold_farmid=r, skin_width_cap=alpha,
                     check_overflow=False)


def cadence(state: ParticleState, cfg: SimConfig, steps: int = 64) -> dict:
    """{"ms_per_step", "rebuilds" (the timed call's), "rebuilds_first"
    (the untimed call's), "cadence" (steps a rebuild), "steps", "state"
    (the timed call's output)}."""
    run = make_adaptive_runner(cfg, steps, return_stats=True)
    out, rb_first = run(state)
    _sync(out)
    t0 = time.perf_counter()
    out, rb = run(out)
    _sync(out)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"ms_per_step": ms, "rebuilds": rb, "rebuilds_first": rb_first,
            "cadence": steps / max(rb, 1), "steps": steps, "state": out}


def report(label: str, r: dict) -> str:
    return (f"{label}: {r['ms_per_step']:.1f} ms/step, {r['rebuilds']} "
            f"rebuilds / {r['steps']} steps (cadence {r['cadence']:.1f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("K", nargs="?", type=int, default=16)
    ap.add_argument("R", nargs="?", type=int, default=4)
    ap.add_argument("steps", nargs="?", type=int, default=64)
    ap.add_argument("alpha", nargs="?", type=float, default=0.75)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--hot-state", default=None,
                    help=f"default {common.HOT_STATE} when it exists")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.K, args.R, args.alpha, args.n)
    print(f"K={args.K} R={args.R} alpha={args.alpha} ({dev.type})",
          flush=True)
    ic = make_initial_state(cfg, device=dev)
    print(report("IC    ", cadence(ic, cfg, args.steps)), flush=True)
    hot = args.hot_state if args.hot_state is not None else (
        common.HOT_STATE if os.path.exists(common.HOT_STATE) else "")
    if hot:
        state, _ = common.load_state(hot, device=dev)
        print(report("hot   ", cadence(state, cfg.replace(n=state.n),
                                       args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
