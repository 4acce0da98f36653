"""Physics metrics: kinetic and potential energy, momentum, bounding box
and the relative energy drift (the BASELINE.json physics criterion)."""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops.forces import soft_term
from nbody_tpu_torch.state import ParticleState


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    """KE = 1/2 sum m |v|^2."""
    return 0.5 * (state.mass * (state.vel**2).sum(dim=1)).sum()


def potential_energy(state: ParticleState, cfg: SimConfig,
                     block: int = 1024) -> torch.Tensor:
    """PE = -G sum_{i<j} m_i m_j / sqrt(|r_ij|^2 + soft), blocked O(N^2)
    (the self pairs, 1/sqrt(soft) each, are subtracted afterwards)."""
    pos, mass = state.pos, state.mass
    g, soft = cfg.g, soft_term(cfg)
    total = pos.new_zeros(())
    for i in range(0, pos.shape[0], block):
        pb, mb = pos[i:i + block], mass[i:i + block]
        d = pos[None, :, :] - pb[:, None, :]
        inv = torch.rsqrt((d * d).sum(dim=-1) + soft)
        total = total + (mb[:, None] * mass[None, :] * inv).sum()
    self_term = (mass * mass).sum() * soft ** -0.5
    return -0.5 * g * (total - self_term)


def momentum(state: ParticleState) -> torch.Tensor:
    return (state.mass[:, None] * state.vel).sum(dim=0)


def bounding_box(state: ParticleState):
    return state.pos.amin(dim=0), state.pos.amax(dim=0)


def total_energy(state: ParticleState, cfg: SimConfig) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state, cfg)


def energy_drift(e0: float, e1: float) -> float:
    """Relative drift |E1 - E0| / |E0|."""
    return abs(e1 - e0) / max(abs(e0), 1e-30)
