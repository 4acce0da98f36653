"""Sustained rate of a config variant from the hot checkpoint (port of
tools/_prof_hotrate.py), optionally also from the initial conditions.

    python -m nbody_tpu_torch.tools.prof_hotrate [hot.npz] [key=val ...]
                                                 [--ic] [--device cuda]

e.g. ``prof_hotrate chip_scratch/hot1m.npz force_tile=512 hold_farmid=8``.
--ic is NBODY_HOTRATE_IC: the same variant from fresh initial conditions
too.  The tool's own config is SimConfig(n, theta=0.5, rebuild_every=16,
hold_farmid=8, check_overflow=False) plus the overrides (force_tile 256,
super-supers on: not v5_bench).

One run_scan call of `steps` steps comes first, as the JAX tool's
"compile + settle k_env" call.  It compiles nothing here (the graphs are
captured in it), and it settles k_env as its name says: each timed call
is on the last call's output, which the port's runner carries on
(Simulation.run_scan), where the JAX package's starts every call at
k_env = K again.  Then `reps` calls are timed on the host clock, with
one device synchronisation at the end; the runner's own read of s_valid
at each rebuild is the only host read inside.
"""

from __future__ import annotations

import argparse
import sys
import time

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils.io import load_checkpoint
from nbody_tpu_torch.utils.profiling import _sync


def make_config(n: int, overrides: dict | None = None) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=16,
                     hold_farmid=8, check_overflow=False).replace(
                         **(overrides or {}))


def sustained(state: ParticleState, cfg: SimConfig, steps: int = 64,
              reps: int = 2) -> dict:
    """{"ms_per_step", "steps_per_sec", "rebuilds" (of the timed calls),
    "state"} after one untimed call of `steps` steps."""
    sim = Simulation(cfg, device=state.device)
    state = sim.run_scan(state, steps)
    _sync(state)
    rb0 = sim.n_rebuilds
    t0 = time.perf_counter()
    for _ in range(reps):
        state = sim.run_scan(state, steps)
    _sync(state)
    dt = (time.perf_counter() - t0) / (steps * reps)
    return {"ms_per_step": 1e3 * dt, "steps_per_sec": 1.0 / dt,
            "rebuilds": sim.n_rebuilds - rb0, "state": state}


def report(label: str, r: dict) -> str:
    return (f"  sustained {label}: {r['ms_per_step']:.2f} ms/step "
            f"({r['steps_per_sec']:.2f} steps/s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("hot", nargs="?", default=common.HOT_STATE)
    ap.add_argument("overrides", nargs="*", help="key=val SimConfig fields")
    ap.add_argument("--ic", action="store_true",
                    help="also the rate from the initial conditions")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    over = common.parse_overrides(args.overrides)
    state, at_step = load_checkpoint(args.hot, device=dev)
    cfg = make_config(state.n, over)
    print(f"[hotrate] n={state.n} step={at_step} overrides={over}",
          flush=True)
    print(report("hot", sustained(state, cfg)), flush=True)
    if args.ic:
        ic = Simulation(cfg, device=dev).init_state()
        print(report("IC", sustained(ic, cfg, reps=1)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
