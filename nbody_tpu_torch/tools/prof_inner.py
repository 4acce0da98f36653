"""The adaptive runner's inner step with frozen bands (port of
tools/_prof_inner.py): the near band alone, near + integrate, the held
far+mid refreshed every R steps or every step, and the runner's own
step with no rebuild, each `steps` steps a row.

    python -m nbody_tpu_torch.tools.prof_inner [n] [steps] [--device cuda]

The tool's own config is SimConfig(n, rebuild_every=16, hold_farmid=4,
check_overflow=False), from the initial conditions: one unskinned
build_bands on the sorted, tile-padded state (velocities padded with
zeros) and its far+mid held.  The rows:

  near only                    p += 1e-6 apply_near(p), steps times
  near + integrate (held afm)  the held far+mid plus near, integrated
  refresh every R              far+mid recomputed at j % R == 0 (a host
                               `if` where the JAX tool takes a lax.cond)
  farmid every step            far+mid and near every step
  full body (no rebuilds)      models.simulation._AdaptiveLoop after its
                               first rebuild, `left` held huge, stepped
                               (its own refresh schedule, no rebuild)

The JAX tool's two flat-carry rows ("flat carries + reshapes", "flat +
refresh cond (R)") time the flat [3N] carries (_flat/_v3), a TPU layout
workaround the port leaves out (ROADMAP "Left out on purpose"); they
print as absent.  The JAX rows are times inside compiled scans; these
are host loops, each row one untimed pass and one pass timed by CUDA
events (the host clock on the CPU), so the kernel launches' host cost is
part of what they measure.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation, _AdaptiveLoop
from nbody_tpu_torch.ops import forces, integrate as integ
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

FULL = "full body (no rebuilds)"
ROWS = ("near only", "near + integrate (held afm)", "refresh every R",
        "farmid every step", FULL)
ABSENT = {
    "flat carries + reshapes": "the port keeps [N, 3] carries (no "
                               "_flat/_v3: ROADMAP 'Left out on purpose')",
    "flat + refresh cond (R)": "no flat carries; see 'refresh every R'",
}
HELD = 10_000_000      # the full body's `left`: no rebuild comes due


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, rebuild_every=16, hold_farmid=4,
                     check_overflow=False)


def _ms_per_step(fn, device, steps: int) -> float:
    return common.device_ms(fn, device, iters=1, warmup=1) / steps


def inner(state: ParticleState, cfg: SimConfig, steps: int = 32,
          rows=ROWS) -> dict:
    """{"ms_per_step": {row: ms}, "pos": {row: positions after the timed
    pass (padded, sorted; the full body's in its own order)}, "rebuilds"
    (the full body's, 1), "absent": ABSENT}."""
    dev = state.device
    out = {"ms_per_step": {}, "pos": {}, "absent": ABSENT}
    if any(r != FULL for r in rows):
        ps, ms, cs, perm, _, _ = common.sorted_padded(state, cfg)
        vel = torch.cat([state.vel[perm],
                         state.vel.new_zeros((ps.shape[0] - state.n, 3))])
        _, supers, bands, tables = forces.build_bands(ps, ms, cs, cfg)
        afm = forces.apply_farmid(ps, supers, tables, cfg)
        r_hold = max(1, cfg.hold_farmid)

        def near(p):
            return forces.apply_near(p, p, ms, bands, cfg)

        def farmid(p):
            return forces.apply_farmid(p, supers, tables, cfg)

        def integrate(p, v, a):
            st = integ.integrate(ParticleState(pos=p, vel=v, mass=ms, acc=a),
                                 a, cfg)
            return st.pos, st.vel

        def near_only():
            p = ps
            for _ in range(steps):
                p = p + 1e-6 * near(p)
            return p

        def stepped(refresh_every):
            p, v, af = ps, vel, afm
            for j in range(steps):
                if refresh_every and j % refresh_every == 0:
                    af = farmid(p)
                p, v = integrate(p, v, af + near(p))
            return p

        runs = {"near only": near_only,
                "near + integrate (held afm)": lambda: stepped(0),
                "refresh every R": lambda: stepped(r_hold),
                "farmid every step": lambda: stepped(1)}
        for row in rows:
            if row in runs:
                res = []
                out["ms_per_step"][row] = _ms_per_step(
                    lambda f=runs[row]: res.append(f()), dev, steps)
                out["pos"][row] = res[-1]
    if FULL in rows:
        loop = _AdaptiveLoop(cfg, state)
        loop.rebuild()
        loop.left = HELD

        def body():
            for _ in range(steps):
                loop.step()

        out["ms_per_step"][FULL] = _ms_per_step(body, dev, steps)
        if loop.n_rebuilds != 1:
            raise RuntimeError(f"the full body rebuilt {loop.n_rebuilds - 1} "
                               f"times with left held at {HELD}")
        out["rebuilds"] = loop.n_rebuilds
        out["pos"][FULL] = loop.pos
    return out


def report(r: dict) -> str:
    lines = [f"{k:28s} {v:7.2f} ms/step" for k, v in r["ms_per_step"].items()]
    lines += [f"{k:28s}  absent: {v}" for k, v in r["absent"].items()]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("steps", nargs="?", type=int, default=32)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    r = inner(Simulation(cfg, device=dev).init_state(), cfg, args.steps)
    print(f"[inner] n={args.n}, {args.steps} steps a row ({dev.type})",
          flush=True)
    print(report(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
