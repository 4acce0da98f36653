"""Semi-implicit Euler (Euler-Cromer) with the v5 MAX_SPEED clamp
(nbody_v5.cu:251-276): velocity first, then the clamp, then position."""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState


def integrate(state: ParticleState, acc: torch.Tensor,
              cfg: SimConfig) -> ParticleState:
    vel = state.vel + acc * cfg.dt
    if cfg.clamp_speed:
        speed_sq = (vel * vel).sum(dim=1, keepdim=True)
        max_sq = cfg.max_speed * cfg.max_speed
        scale = torch.where(speed_sq > max_sq,
                            cfg.max_speed * torch.rsqrt(speed_sq),
                            torch.ones_like(speed_sq))
        vel = vel * scale
    pos = state.pos + vel * cfg.dt
    return ParticleState(pos=pos, vel=vel, mass=state.mass, acc=acc)
