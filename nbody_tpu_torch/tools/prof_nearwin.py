"""Near-band window occupancy at a bench-like state, and the time of the
near kernel and of far+mid on that structure (port of
tools/_prof_nearwin.py).

    python -m nbody_tpu_torch.tools.prof_nearwin [advance_steps] [N]
                                                 [--device cuda]

The near sweep takes one aligned 128-wide source window per distinct
window entry of a tile (same-window child runs OR-merged into one lane
mask by forces._window_masks).  Occupancy is the live mask bits over
the fetched lanes (128 a window); near_span_kernel<4> runs its pair loop
over the live lanes only (a ring of them), so its executed pairs are the
live lanes times force_tile, counted here as chip_smoke.py's bounds
count them (20 FP32 operations a pair).  Times are CUDA-event means on
the card (the host's median on the CPU); the JAX tool's relay
subtraction and its DMA-segment rounding (KSEG8) have no counterpart.

The tool's own config is SimConfig(n, theta=0.5, rebuild_every=16,
hold_farmid=4, check_overflow=False) (force_tile 256, super-supers on:
not v5_bench); the skins are adaptive_drift's for rebuild_every steps.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation, adaptive_drift
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

OPS_PER_PAIR = 20


def make_config(n: int = 1_000_000) -> SimConfig:
    return SimConfig(n=n, theta=0.5, use_pallas=True, rebuild_every=16,
                     hold_farmid=4, check_overflow=False)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    v = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(v)
    for k in range(32):
        n += (v >> k) & 1
    return n


def live_lanes(bands) -> int:
    """Set mask bits over each tile's first win_cnt windows, summed."""
    wc = bands.win_cnt.to(torch.int64)
    lane_ok = torch.arange(bands.win_first.shape[1],
                           device=wc.device) < wc[:, None]
    return int((popcount32(bands.win_mask) * lane_ok[:, None, :]).sum())


def build(state: ParticleState, cfg: SimConfig, skins: bool):
    """(ps, ms, ss, bands, tables): the Morton-sorted padded inputs and
    one build at `state` (skins: adaptive_drift's)."""
    ps, ms, cs, perm, _, size = common.sorted_padded(state, cfg)
    d = None
    if skins:
        npad = ps.shape[0]
        d = adaptive_drift(common.norms_padded(state.vel[perm], npad),
                           common.norms_padded(state.acc[perm], npad),
                           cs, size, cfg)
    _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg, drift=d)
    return ps, ms, ss, bands, tables


def window_stats(state: ParticleState, cfg: SimConfig, skins: bool,
                 iters: int = 5) -> dict:
    """Windows per tile, live lanes, occupancy, and the near and far+mid
    times of one build at `state` (skins: adaptive_drift's)."""
    ps, ms, supers, bands, tables = build(state, cfg, skins)
    windows = int(bands.win_cnt.sum())
    lanes = live_lanes(bands)
    near_ms = common.device_ms(
        lambda: forces.apply_near(ps, ps, ms, bands, cfg), ps.device, iters)
    farmid_ms = common.device_ms(
        lambda: forces.apply_farmid(ps, supers, tables, cfg), ps.device,
        iters)
    pairs = lanes * cfg.force_tile
    return {"windows_per_tile": windows / bands.win_cnt.shape[0],
            "windows": windows, "live_lanes": lanes,
            "occupancy": lanes / max(windows * 128, 1),
            "near_pairs": pairs, "near_ms": near_ms,
            "near_gflop": OPS_PER_PAIR * pairs / 1e9,
            "farmid_ms": farmid_ms}


def report(label: str, r: dict, device: str) -> str:
    return (f"[{label}] windows/target {r['windows_per_tile']:.1f}  "
            f"occupancy {r['occupancy']:.3f}  live lanes {r['live_lanes']}\n"
            f"[{label}] near kernel: {r['near_ms']:.3f} ms ({device}), "
            f"executed {r['near_gflop']:.1f} Gflop -> "
            f"{r['near_gflop'] / r['near_ms']:.2f} Tflop/s eff\n"
            f"[{label}] far+mid: {r['farmid_ms']:.3f} ms ({device})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=128)
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    cfg = make_config(args.n)
    sim = Simulation(cfg, device=dev)
    state = common.advance(sim, sim.init_state(),
                           max(args.steps // 128, 0) * 128, 128,
                           lambda m: print(m, flush=True))
    for label, skins in (("live  ", False), ("skins ", True)):
        print(report(label, window_stats(state, cfg, skins), dev.type),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
