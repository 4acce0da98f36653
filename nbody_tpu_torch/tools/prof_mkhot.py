"""Advance the shipping 1M config to a hot (contracted-core) state and
checkpoint it (port of tools/_prof_mkhot.py), so the hot-state tools
load it instead of advancing again.

    python -m nbody_tpu_torch.tools.prof_mkhot [n] [steps] [out.npz]
                                               [--device cuda]

The config is PRESETS["v5_bench"] with check_overflow=False (the
integrator the drift gate runs); the state advances from the initial
conditions in run_scan calls of at most 128 steps.  The checkpoint is
utils/io.save_checkpoint's npz, which both packages load; the other
tools read it with --hot-state (or a positional path).  The default
output is chip_scratch/hot1m.npz under the working directory (the JAX
tool writes /tmp/hot1m.npz).
"""

from __future__ import annotations

import argparse
import os
import sys

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils.io import save_checkpoint

CHUNK = 128


def make_config(n: int = 1_000_000) -> SimConfig:
    return PRESETS["v5_bench"].replace(n=n, check_overflow=False)


def make_hot(state: ParticleState, cfg: SimConfig, steps: int = 1024,
             chunk: int = CHUNK, log=print) -> dict:
    """{"state", "steps", "rebuilds"}: `state` advanced `steps` steps."""
    sim = Simulation(cfg, device=state.device)
    state = common.advance(sim, state, steps, chunk, log)
    return {"state": state, "steps": steps, "rebuilds": sim.n_rebuilds}


def save_hot(path: str, state: ParticleState, step: int) -> None:
    """Write the checkpoint, making its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    save_checkpoint(path, state, step=step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("steps", nargs="?", type=int, default=1024)
    ap.add_argument("out", nargs="?", default=common.HOT_STATE)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    sim = Simulation(cfg, device=dev)
    res = make_hot(sim.init_state(), cfg, args.steps,
                   log=lambda m: print(m, flush=True))
    save_hot(args.out, res["state"], args.steps)
    print(f"[mkhot] wrote {args.out} at step {args.steps}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
