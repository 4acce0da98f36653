"""The adaptive runner's arithmetic (port of tools/_prof_runner.py): the
runner for `steps` steps with its rebuild count, one bare rebuild, and
the fit total(s) = x s + y n_rb(s) + c over the runs, so that
runner == inner step * steps + rebuild * n_rb can be checked.

    python -m nbody_tpu_torch.tools.prof_runner [n] [steps] [--device cuda]

The tool's own config is SimConfig(n, rebuild_every=16, hold_farmid=4,
check_overflow=False) (force_tile 256, super-supers on: not v5_bench),
from the initial conditions.  Each run follows one untimed call (as the
JAX tool's timed second call follows the one that compiles) and is
timed REPS times on the host clock, with one device synchronisation at
its end: the runner's read of s_valid at each rebuild is the only host
read inside.  The JAX tool's single timed call becomes the median of
REPS (one host-clock reading per run moved x and y by 2-4x between
identical runs).  The JAX tool's flat [3N] carries have no counterpart.
The fit runs over `steps` and `fit_steps` (64 and 128) by least squares
on the medians, and once on each repetition alone for the spread; where
the rebuild counts are proportional to the steps (at the hot state
every step rebuilds) y is the bare rebuild's time and only x and c are
fitted ("y_from" says which).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation, \
    make_adaptive_runner, next_envelope
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.utils.profiling import _sync
from nbody_tpu_torch.tools import common

FIT_STEPS = (64, 128)
REPS = 3                    # timed calls of each run, median taken


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, rebuild_every=16, hold_farmid=4,
                     check_overflow=False)


def run_timed(state: ParticleState, cfg: SimConfig, steps: int) -> dict:
    """The adaptive runner from `state`, one untimed call and then REPS
    timed ones: {"ms" (their median total), "ms_all", "rebuilds"}."""
    run = make_adaptive_runner(cfg, steps, return_stats=True)
    _sync(run(state)[0])
    times, counts = [], set()
    for _ in range(REPS):
        t0 = time.perf_counter()
        out, n_rb = run(state)
        _sync(out)
        times.append(1e3 * (time.perf_counter() - t0))
        counts.add(n_rb)
    if len(counts) != 1:
        raise RuntimeError(f"rebuild counts {counts} differ between calls "
                           f"from one state")
    return {"ms": float(np.median(times)), "ms_all": times,
            "rebuilds": counts.pop()}


def rebuild_timed(state: ParticleState, cfg: SimConfig) -> dict:
    """One bare rebuild at k_env = K (common.first_rebuild), one untimed
    call and then REPS timed ones: {"ms" (median), "ms_all", "s_valid",
    "k_next"}."""
    rebuild, args = common.first_rebuild(state, cfg)
    _sync(rebuild(*args)[0][0])
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        _, _, (s_valid, _) = rebuild(*args)
        _sync(s_valid)
        times.append(1e3 * (time.perf_counter() - t0))
    return {"ms": float(np.median(times)), "ms_all": times,
            "s_valid": int(s_valid),
            "k_next": next_envelope(int(s_valid), cfg)}


def fit(runs: dict, y_bare: float) -> dict:
    """Least squares of total(s) = x s + y n_rb(s) + c over {s: run},
    and of total(s) = step s + c (step: a step's cost with its share of
    the rebuilds).  Where the rebuild counts are proportional to the
    steps (every step a rebuild, as at the hot state) they cannot
    separate x from y: then y is the bare rebuild's time, y_bare, and x
    and c are fitted."""
    s = np.array([float(k) for k in runs])
    k = np.array([float(r["rebuilds"]) for r in runs.values()])
    t = np.array([r["ms"] for r in runs.values()])
    ones = np.ones_like(s)
    (x, y, c), _, rank, _ = np.linalg.lstsq(np.stack([s, k, ones], axis=1),
                                            t, rcond=None)
    step = np.linalg.lstsq(np.stack([s, ones], axis=1), t, rcond=None)[0][0]
    y_from = "fit"
    if rank < 3:
        (x, c), _, _, _ = np.linalg.lstsq(np.stack([s, ones], axis=1),
                                          t - y_bare * k, rcond=None)
        y, y_from = y_bare, "bare rebuild"
    return {"x_ms": float(x), "y_ms": float(y), "c_ms": float(c),
            "step_ms": float(step), "rank": int(rank), "y_from": y_from}


def closure(state: ParticleState, cfg: SimConfig, steps: int = 32,
            fit_steps=FIT_STEPS) -> dict:
    """{"runs": {s: run_timed}, "rebuild": rebuild_timed, "fit" (of the
    medians), "spread": {"x_ms", "y_ms", "c_ms": (min, max) over the fits
    of each repetition alone}}."""
    runs = {s: run_timed(state, cfg, s) for s in (steps, *fit_steps)}
    rebuild = rebuild_timed(state, cfg)
    each = [fit({s: {"ms": r["ms_all"][i], "rebuilds": r["rebuilds"]}
                 for s, r in runs.items()}, rebuild["ms_all"][i])
            for i in range(REPS)]
    return {"runs": runs, "rebuild": rebuild,
            "fit": fit(runs, rebuild["ms"]),
            "spread": {k: (min(f[k] for f in each), max(f[k] for f in each))
                       for k in ("x_ms", "y_ms", "c_ms")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("steps", nargs="?", type=int, default=32)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    state = Simulation(cfg, device=dev).init_state()
    r = closure(state, cfg, args.steps)
    for s, run in r["runs"].items():
        print(f"runner {s} steps: {run['ms'] / s:7.2f} ms/step  "
              f"n_rb={run['rebuilds']}  total={run['ms']:.0f} ms", flush=True)
        if s == args.steps:
            rb = r["rebuild"]
            print(f"one rebuild: {rb['ms']:7.2f} ms  s_valid="
                  f"{rb['s_valid']} k_env={rb['k_next']}", flush=True)
    f = r["fit"]
    print(f"fit total(s) = x s + y n_rb + c: x {f['x_ms']:.2f} ms/step, "
          f"y {f['y_ms']:.2f} ms/rebuild ({f['y_from']}), c "
          f"{f['c_ms']:.1f} ms (rank {f['rank']}); a step with its share "
          f"of the rebuilds {f['step_ms']:.2f} ms", flush=True)
    sp = r["spread"]
    print(f"spread over the {REPS} repetitions' own fits: " + ", ".join(
        f"{k[0]} {lo:.2f}..{hi:.2f}" for k, (lo, hi) in sp.items()),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
