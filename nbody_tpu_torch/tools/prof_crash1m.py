"""Advance in chunks and print the band diagnostics after each one, so
the last good state of a failing run is visible (port of
tools/_prof_crash1m.py).

    python -m nbody_tpu_torch.tools.prof_crash1m [n] [total_steps] [chunk]
                                                 [--device cuda]

The tool's own config is SimConfig(n, rebuild_every=16, hold_farmid=4,
check_overflow=False) (force_tile 256, super-supers on: not v5_bench),
from the initial conditions.  Each chunk is one run_scan call, timed on
the host clock until the device has finished it.
"""

from __future__ import annotations

import argparse
import sys
import time

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils import metrics
from nbody_tpu_torch.utils.profiling import _sync


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, rebuild_every=16, hold_farmid=4,
                     check_overflow=False)


def chunk(state: ParticleState, cfg: SimConfig, steps: int = 128,
          sim: Simulation | None = None) -> dict:
    """{"state", "ms_per_step", "rebuilds", "diagnostics"}: `steps` steps
    of run_scan, then metrics.bh_diagnostics at the new state."""
    sim = sim or Simulation(cfg, device=state.device)
    rb0 = sim.n_rebuilds
    t0 = time.perf_counter()
    state = sim.run_scan(state, steps)
    _sync(state)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    return {"state": state, "ms_per_step": ms,
            "rebuilds": sim.n_rebuilds - rb0,
            "diagnostics": metrics.bh_diagnostics(state, cfg)}


def report(done: int, r: dict) -> str:
    d = r["diagnostics"]
    return (f"  {done:5d}: {r['ms_per_step']:7.2f} ms/step | "
            f"cells={d['n_cells']} ss={d['ss_mean']:.1f} "
            f"sup={d['sup_mean']:.1f} mid={d['mid_mean']:.1f} "
            f"cmid={d['cmid_mean']:.1f} near={d['near_mean']:.1f} "
            f"win={d['win_mean']:.1f} | ovf c={int(d['cell_overflow'])} "
            f"g2={int(d['g2_overflow'])} ss={int(d['ss_overflow'])} "
            f"s={int(d['sup_overflow'])} m={int(d['mid_overflow'])} "
            f"cm={int(d['cmid_overflow'])} n={int(d['near_overflow'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("total", nargs="?", type=int, default=1024)
    ap.add_argument("chunk", nargs="?", type=int, default=128)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    print(f"[crash1m] n={args.n} total={args.total} chunk={args.chunk}",
          flush=True)
    done = 0
    while done < args.total:
        r = chunk(state, cfg, args.chunk, sim)
        state, done = r["state"], done + args.chunk
        print(report(done, r), flush=True)
    print("[crash1m] survived", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
