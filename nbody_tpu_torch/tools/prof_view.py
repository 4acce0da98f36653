"""Live-view frame rate (port of tools/_prof_view.py): the real SimViewer
sim thread (device step, render and quantise of frame k+1 enqueued
before the host fetch and JPEG of frame k) without its HTTP server, and
the rate of published frames.

    python -m nbody_tpu_torch.tools.prof_view [n] [frames]
        [steps_per_frame] [--device cuda]

The tool's own config is SimConfig(n, rebuild_every=16, hold_farmid=4)
(not the v5 preset's hold of 8), from the initial conditions.  The first
published frame (the kernels' build and the first rebuild) is left out
of the rate; the run stops through viewer.stop().  A frame not published
within 900 s raises.
"""

from __future__ import annotations

import argparse
import sys
import time

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.viz.viewer import SimViewer

DEADLINE_S = 900.0


def make_config(n: int = 500_000) -> SimConfig:
    return SimConfig(n=n, rebuild_every=16, hold_farmid=4)


def view_rate(state: ParticleState, cfg: SimConfig, frames: int = 24,
              steps_per_frame: int = 1) -> dict:
    """{"frames" (published after the first), "seconds", "fps",
    "ms_per_frame", "rebuilds" (the stepper's, first frame included)}."""
    spf = steps_per_frame
    viewer = SimViewer(Simulation(cfg, device=state.device), state, cfg,
                       steps_per_frame=spf)
    if viewer._stepper is None:
        raise ValueError("the config has no persistent stepper")
    deadline = time.perf_counter() + DEADLINE_S

    def wait_for(steps: int, what: str) -> None:
        while viewer.step_count < steps:
            if viewer.error is not None:
                raise RuntimeError("the sim thread failed") from viewer.error
            if time.perf_counter() > deadline:
                raise RuntimeError(f"{what} within {DEADLINE_S:.0f} s")
            time.sleep(0.02)

    viewer.start()
    try:
        wait_for(1, "no first frame")
        c0, t0 = viewer.step_count, time.perf_counter()
        wait_for(c0 + frames * spf, "the frame loop stalled: not all frames")
        c1, t1 = viewer.step_count, time.perf_counter()
    finally:
        viewer.stop()
    published = (c1 - c0) // spf
    fps = published / (t1 - t0)
    return {"frames": published, "seconds": t1 - t0, "fps": fps,
            "ms_per_frame": 1e3 / fps,
            "rebuilds": viewer._stepper.n_rebuilds}


def report(n: int, spf: int, r: dict) -> str:
    return (f"[pipelined] n={n} spf={spf} {r['frames']} frames in "
            f"{r['seconds']:.2f}s = {r['fps']:.2f} FPS "
            f"({r['ms_per_frame']:.1f} ms/frame)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=500_000)
    ap.add_argument("frames", nargs="?", type=int, default=24)
    ap.add_argument("steps_per_frame", nargs="?", type=int, default=1)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    state = Simulation(cfg, device=dev).init_state()
    print(report(args.n, args.steps_per_frame,
                 view_rate(state, cfg, args.frames, args.steps_per_frame)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
