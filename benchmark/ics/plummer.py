"""A Plummer sphere (Aarseth, Henon & Wielen 1974, A&A 37, 183), the
field's standard N-body test model, drawn on the device from the seed.

Masses are uniform in [2, 7) as the upstream disk's; M is their sum.
Radii invert the cumulative mass M(<r) / M = r^3 / (r^2 + a^2)^(3/2) for
a fraction drawn uniformly below `mass_cut`; directions are isotropic.
Speeds are q v_esc(r), v_esc = sqrt(2 G M) (r^2 + a^2)^(-1/4), with q
drawn from the distribution function's g(q) = q^2 (1 - q^2)^(7/2) by von
Neumann rejection; velocity directions are isotropic.  The centre of
mass and its velocity are removed.  Every draw comes from one
torch.Generator seeded with the seed, in a fixed order.
"""

from __future__ import annotations

import math

import torch

# g(q) peaks at 0.0921 (q = sqrt(2/9)); the rejection box is [0, 1) x [0, 0.1)
_G_BOX = 0.1


def _isotropic(k: int, gen: torch.Generator, device) -> torch.Tensor:
    """k unit vectors, uniform on the sphere."""
    u = torch.rand((k, 2), generator=gen, device=device, dtype=torch.float64)
    cos_t = 1.0 - 2.0 * u[:, 0]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u[:, 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=1)


def _speed_fractions(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n draws of q from g(q) by rejection, in rounds of 4 candidates for
    each body still unassigned (the acceptance is 43%)."""
    q = torch.full((n,), -1.0, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        k = todo.numel()
        cand = torch.rand((k, 4, 2), generator=gen, device=device,
                          dtype=torch.float64)
        x, y = cand[..., 0], cand[..., 1] * _G_BOX
        ok = y < x * x * (1.0 - x * x) ** 3.5
        first = torch.argmax(ok.to(torch.int8), dim=1)
        hit = ok.any(dim=1)
        q[todo[hit]] = x[hit, first[hit]]
        todo = todo[~hit]
    return q


def make(n: int, seed: int, g: float, device=None, scale_radius=728.0,
         mass_cut=0.999):
    """(pos [n, 3], vel [n, 3], mass [n]) float32 tensors on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = torch.float64
    mass = 2.0 + 5.0 * torch.rand(n, generator=gen, device=device, dtype=f64)
    m_tot = float(mass.sum())
    a = scale_radius
    x = mass_cut * torch.rand(n, generator=gen, device=device, dtype=f64)
    r = a / torch.sqrt(x ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _isotropic(n, gen, device)
    q = _speed_fractions(n, gen, device)
    v_esc = math.sqrt(2.0 * g * m_tot) * (r * r + a * a) ** -0.25
    vel = (q * v_esc)[:, None] * _isotropic(n, gen, device)
    w = (mass / m_tot)[:, None]
    pos = pos - (w * pos).sum(dim=0)
    vel = vel - (w * vel).sum(dim=0)
    return (pos.to(torch.float32), vel.to(torch.float32),
            mass.to(torch.float32))
