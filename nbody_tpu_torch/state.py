"""Particle state: [N, 3] / [N] float32 tensors on one device."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ParticleState(NamedTuple):
    """Positions, velocities, masses and last accelerations of N bodies."""

    pos: torch.Tensor    # [N, 3] float32
    vel: torch.Tensor    # [N, 3] float32
    mass: torch.Tensor   # [N]    float32
    acc: torch.Tensor    # [N, 3] float32, acceleration of the last step

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @staticmethod
    def create(pos, vel, mass, acc=None, device=None) -> "ParticleState":
        """Build a state from array-likes (numpy or tensors) as float32."""
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        pos = f32(pos)
        acc = torch.zeros_like(pos) if acc is None else f32(acc)
        return ParticleState(pos=pos, vel=f32(vel), mass=f32(mass), acc=acc)

    def permute(self, perm: torch.Tensor) -> "ParticleState":
        """Reorder every per-particle tensor by `perm`."""
        return ParticleState(pos=self.pos[perm], vel=self.vel[perm],
                             mass=self.mass[perm], acc=self.acc[perm])

    def to(self, device) -> "ParticleState":
        return ParticleState(*(x.to(device) for x in self))
