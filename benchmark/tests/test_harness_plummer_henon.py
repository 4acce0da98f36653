"""The Plummer sphere of the lonestar_bh_1m cell (ics/plummer_henon.py):
masses 1/N, radii inside the 0.999 mass cut, Henon units (kinetic energy
1/4, virial ratio 2K/|W| = 1 within sampling noise), the same bodies for
the same seed, and the port's generator (nbody_tpu_torch.init) bit for
bit."""

import math

import pytest
import torch

from benchmark.ics import plummer_henon
from nbody_tpu_torch.init import plummer_henon as port_plummer

torch.set_num_threads(2)


@pytest.mark.parametrize("n,seed", [(1, 0), (777, 42), (5000, 2**31 + 11)])
def test_equals_the_ports_generator(n, seed):
    pos, vel, mass = plummer_henon.make(n, seed, 1.0)
    ref = port_plummer(n, seed, 1.0, device="cpu")
    for got, want in ((pos, ref.pos), (vel, ref.vel), (mass, ref.mass)):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_same_seed_same_bodies():
    a = plummer_henon.make(2000, 5, 1.0, device="cpu")
    b = plummer_henon.make(2000, 5, 1.0, device="cpu")
    c = plummer_henon.make(2000, 6, 1.0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_masses_radii_and_henon_units():
    n = 50_000
    pos, vel, mass = (x.to(torch.float64) for x in plummer_henon.make(
        n, 2**31 + 5, 1.0, device="cpu"))
    assert torch.equal(mass, torch.full((n,), float(torch.tensor(
        1.0 / n, dtype=torch.float32)), dtype=torch.float64))
    r = pos.norm(dim=1)
    r_cut = plummer_henon.RSC / math.sqrt(plummer_henon.CUT ** (-2 / 3) - 1)
    assert float(r.max()) <= r_cut * (1 + 1e-6)
    # half-mass radius rsc / sqrt((1/2)^(-2/3) - 1) of the uncut model,
    # at 0.999 / 2 of the cut one
    r_half = plummer_henon.RSC / math.sqrt((0.999 / 2) ** (-2 / 3) - 1)
    assert abs(float(r.median()) / r_half - 1) < 0.02
    # Henon units: M = 1, E = -1/4, so K = 1/4 and W = -1/2 (the 0.999
    # cut moves them by well under the sampling noise)
    ke = 0.5 * float((mass * (vel ** 2).sum(1)).sum())
    assert abs(ke / 0.25 - 1) < 0.03
    gen = torch.Generator().manual_seed(1)
    rows = torch.randperm(n, generator=gen)[:4096]
    phi = torch.zeros(len(rows), dtype=torch.float64)
    for i in range(0, n, 10_000):
        d = (pos[None, i:i + 10_000] - pos[rows, None]).norm(dim=2)
        w = torch.where(d > 0, mass[None, i:i + 10_000] / d,
                        torch.zeros_like(d))
        phi -= w.sum(1)
    w_pot = 0.5 * float((mass[rows] * phi).sum()) * n / len(rows)
    assert abs(2 * ke / abs(w_pot) - 1) < 0.05
    # isotropic speeds
    s = (vel ** 2).mean(0)
    assert float(s.max() / s.min()) < 1.05
