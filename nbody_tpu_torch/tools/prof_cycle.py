"""The K-cycle split (port of tools/_prof_cycle.py): a band build and a
band evaluation unskinned and with K-step skins, then K inner steps on
the skinned bands.

    python -m nbody_tpu_torch.tools.prof_cycle [n] [k] [--device cuda]

The tool's own config is SimConfig(n, check_overflow=False,
rebuild_every=k) (force_tile 256, super-supers on), advanced 16 steps
through Simulation.run_scan from the initial conditions.  Then a 30-bit
sort (the JAX tool's morton.encode30; the builds run at morton_bits=30),
velocities padded with zeros, and the tool's own skin v dt k
skin_safety (not adaptive_drift).  Each build_bands and apply_bands is
timed as the median of 5 calls after one, with the mean band counts of
its build; then k steps of apply_bands + integrate on the skinned bands,
the same way (a host loop where the JAX tool scans).  CUDA events around
each call on the card, the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces, integrate as integ
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils.profiling import _sync

ADVANCE = 16
BANDS = ("sup", "mid", "cmid", "near", "wins")


def make_config(n: int = 1_000_000, k: int = 8) -> SimConfig:
    return SimConfig(n=n, check_overflow=False, rebuild_every=k)


def cycle(state: ParticleState, cfg: SimConfig, iters: int = 5) -> dict:
    """{"builds": {label: {"build_ms", "apply_ms", "counts": {band: mean
    per tile}}}, "inner_ms" (k steps), "inner_ms_per_step", "k"} at
    k = cfg.rebuild_every."""
    dev = state.device
    k = cfg.rebuild_every
    c30 = cfg.replace(morton_bits=30)
    ps, ms, cs, perm, _, _ = common.sorted_padded(state, c30)
    vel = torch.cat([state.vel[perm],
                     state.vel.new_zeros((ps.shape[0] - state.n, 3))])
    v = torch.sqrt((vel * vel).sum(dim=1))
    drift_k = v * cfg.dt * k * cfg.skin_safety
    out = {"builds": {}, "k": k}
    for label, drift in (("unskinned", torch.zeros_like(drift_k)),
                         (f"skin(K={k})", drift_k)):
        def build():
            return forces.build_bands(ps, ms, cs, c30, drift=drift)

        _, supers, bands, tables = build()

        def apply():
            return forces.apply_bands(ps, ms, supers, bands, tables, c30)

        out["builds"][label] = {
            "build_ms": common.device_times(build, dev, iters)["median_ms"],
            "apply_ms": common.device_times(apply, dev, iters)["median_ms"],
            "counts": {b: float(getattr(bands, common.COUNTS[b]).to(
                torch.float32).mean()) for b in BANDS}}

    def inner_k():
        p, vv = ps, vel
        for _ in range(k):
            a = forces.apply_bands(p, ms, supers, bands, tables, c30)
            st = integ.integrate(ParticleState(pos=p, vel=vv, mass=ms, acc=a),
                                 a, c30)
            p, vv = st.pos, st.vel
        return p

    out["inner_ms"] = common.device_times(inner_k, dev, iters)["median_ms"]
    out["inner_ms_per_step"] = out["inner_ms"] / k
    return out


def report(r: dict) -> str:
    lines = [f"{label:12s} build {b['build_ms']:8.1f} ms  apply "
             f"{b['apply_ms']:7.1f} ms  " + " ".join(
                 f"{k}={v:.0f}" for k, v in b["counts"].items())
             for label, b in r["builds"].items()]
    lines.append(f"inner x{r['k']} stepped: {r['inner_ms']:.1f} ms total -> "
                 f"{r['inner_ms_per_step']:.1f} ms/step")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k", nargs="?", type=int, default=8)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n, args.k)
    sim = Simulation(cfg, device=dev)
    state = sim.run_scan(sim.init_state(), ADVANCE)
    _sync(state)
    print(f"[cycle] n={args.n} k={args.k} after {ADVANCE} steps "
          f"({dev.type})", flush=True)
    print(report(cycle(state, cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
