"""Kilostep energy-drift gate (port of tools/_prof_kilostep.py): runs
the canonical protocol, ``utils.metrics.drift_protocol`` from the
initial conditions (E0 at entry), so the gate and chip_smoke.py's
[runner] are one code path.

    python -m nbody_tpu_torch.tools.prof_kilostep [K] [R] [N]
        [--adaptive 0|1] [--alpha A] [--caps sup,mid,cmid,near]
        [--over "force_tile=512,farmid_span_rebuilds=1,..."]
        [--steps 1024] [--chunk 32] [--log-every 128] [--save hot.npz]
        [--device cuda]

The flags are the JAX tool's environment knobs (KS_ADAPTIVE, KS_ALPHA,
KS_CAPS, KS_OVER, KS_STEPS, KS_CHUNK, KS_LOG_EVERY, KS_SAVE).  The base
is the shipping preset: at K=16 R=8 the config is PRESETS["v5_bench"]
with check_overflow=False, which only skips the one-time overflow probe.
"""

from __future__ import annotations

import argparse
import sys

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools.prof_mkhot import save_hot
from nbody_tpu_torch.utils import metrics


def make_config(k: int = 16, r: int = 8, n: int = 1_000_000,
                adaptive: bool = True, alpha: float = 0.75,
                overrides: dict | None = None) -> SimConfig:
    return PRESETS["v5_bench"].replace(
        n=n, theta=0.5, use_pallas=True, adaptive_rebuild=adaptive,
        rebuild_every=k, hold_farmid=r, skin_width_cap=alpha,
        check_overflow=False).replace(**(overrides or {}))


def gate(state: ParticleState, cfg: SimConfig, steps: int = 1024,
         chunk: int = 32, log_every: int = 128, log=print) -> dict:
    """drift_protocol's dict plus "sim" (its Simulation, whose
    n_rebuilds counts the run's rebuilds) and "ke" (the final kinetic
    energy).  With log_every > 0, E0 is logged first and E, the drift
    and KE every log_every steps (each one softened O(N^2) energy)."""
    sim = Simulation(cfg, device=state.device)
    logger = None
    if log_every > 0:
        e0 = float(metrics.total_energy(state, cfg))
        log(f"E0 = {e0:.6e}")

        def logger(done, secs, st):
            if done % log_every:
                return
            e = float(metrics.total_energy(st, cfg))
            ke = float(metrics.kinetic_energy(st))
            log(f"  {done} steps, {secs:.1f}s  E={e:.4e} "
                f"drift={abs(e - e0) / abs(e0):.5f} KE={ke:.3e}")

    dp = metrics.drift_protocol(sim, state, n_steps=steps, chunk=chunk,
                                log=logger)
    dp["sim"] = sim
    dp["ke"] = float(metrics.kinetic_energy(dp["state"]))
    return dp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("K", nargs="?", type=int, default=16)
    ap.add_argument("R", nargs="?", type=int, default=8)
    ap.add_argument("N", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--adaptive", type=int, choices=(0, 1), default=1)
    ap.add_argument("--alpha", type=float, default=0.75)
    ap.add_argument("--caps", default="", help="sup,mid,cmid,near")
    ap.add_argument("--over", default="", help="k=v,k=v SimConfig overrides")
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--log-every", type=int, default=128)
    ap.add_argument("--save", default="", help="write the final state here")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    caps = common.parse_caps(args.caps) if args.caps else {}
    caps.update(common.parse_overrides(args.over))
    cfg = make_config(args.K, args.R, args.N, bool(args.adaptive),
                      args.alpha, caps)

    def log(m):
        print(m, flush=True)

    log(f"caps={caps}")
    log(f"K={args.K} R={args.R} N={args.N} adaptive={bool(args.adaptive)} "
        f"alpha={args.alpha} steps={args.steps} chunk={args.chunk}")
    state = Simulation(cfg, device=dev).init_state()
    dp = gate(state, cfg, args.steps, args.chunk, args.log_every, log)
    log(f"E1 = {dp['e1']:.6e}  drift_{dp['drift_steps']} = "
        f"{dp['drift']:.6f}")
    log(f"avg {dp['avg_steps_per_sec']:.2f} steps/s  "
        f"hot {dp['hot_steps_per_sec']:.2f} steps/s  "
        f"({dp['seconds']:.0f}s total)")
    log(f"KE = {dp['ke']:.4e}")
    if args.save:
        save_hot(args.save, dp["state"], dp["drift_steps"])
        log(f"saved hot state -> {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
