"""The Plummer sphere of SPLASH-2's barnes as LonestarGPU's bh makes its
input (Burtscher & Pingali, GPU Computing Gems Emerald Edition ch. 6,
2011), in Henon units: a frozen copy of
``nbody_tpu_torch.init.plummer_henon``, so that the benchmark makes its
own inputs.

Masses 1/N; radius scale rsc = 3 pi / 16 and velocity scale vsc =
sqrt(G / rsc); radii r = 1 / sqrt((0.999 u)^(-2/3) - 1) from a mass
fraction below 0.999, times rsc, along a direction drawn by rejection from
the cube [-1, 1)^3 into the unit ball; speed fractions q by rejection from
q^2 (1 - q^2)^3.5 in the box [0, 1) x [0, 0.1), the speed vsc q sqrt(2)
(1 + r^2)^(-1/4), along a second such direction; no centre-of-mass shift.
Every draw comes, in that order, from one CPU torch.Generator seeded with
the seed, in float64 (rejection in rounds of one candidate for each body
still unassigned), rounded to float32 and then moved to the device, so a
seed gives the same bodies on every device.
"""

from __future__ import annotations

import math

import torch

RSC = 3.0 * math.pi / 16.0
CUT = 0.999
BOX = 0.1


def _rejected(n: int, gen: torch.Generator, width: int, accept):
    out = torch.empty((n, width), dtype=torch.float64)
    todo = torch.arange(n)
    while todo.numel():
        cand = torch.rand((todo.numel(), width), generator=gen,
                          dtype=torch.float64)
        ok = accept(cand)
        out[todo[ok]] = cand[ok]
        todo = todo[~ok]
    return out


def _ball_directions(n: int, gen: torch.Generator) -> torch.Tensor:
    def inside(c):
        x = 2.0 * c - 1.0
        return (x * x).sum(dim=1) <= 1.0

    x = 2.0 * _rejected(n, gen, 3, inside) - 1.0
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True))


def make(n: int, seed: int, g: float, device=None):
    """(pos [n, 3], vel [n, 3], mass [n]) float32 tensors on `device`."""
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    u = torch.rand(n, generator=gen, dtype=f64)
    r = 1.0 / torch.sqrt((CUT * u) ** (-2.0 / 3.0) - 1.0)
    pos = (RSC * r)[:, None] * _ball_directions(n, gen)

    def under_g(c):
        x, y = c[:, 0], c[:, 1] * BOX
        return y <= x * x * (1.0 - x * x) ** 3.5

    q = _rejected(n, gen, 2, under_g)[:, 0]
    speed = math.sqrt(g / RSC) * q * torch.sqrt(2.0 / torch.sqrt(1.0 + r * r))
    vel = speed[:, None] * _ball_directions(n, gen)
    mass = torch.full((n,), 1.0 / n, dtype=f64)
    return tuple(x.to(torch.float32).to(device) for x in (pos, vel, mass))
