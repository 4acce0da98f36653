"""The benchmark's own start states: the frozen upstream disk equals the
port's generator bit for bit, and the Plummer sampler follows the model
(half-mass radius, virial ratio, isotropy, no drift) within sampling
noise."""

import math

import numpy as np
import pytest
import torch

from benchmark.ics import disk_msvc, plummer
from nbody_tpu_torch.init import disk_galaxy_msvc

torch.set_num_threads(2)


@pytest.mark.parametrize("n,seed", [(1, 0), (777, 42), (5000, 2**31 + 11)])
def test_disk_equals_the_ports_generator(n, seed):
    pos, vel, mass = disk_msvc.make(n, seed, 0.5)
    ref = disk_galaxy_msvc(n, seed, 0.5, device="cpu")
    assert np.array_equal(pos, ref.pos.numpy())
    assert np.array_equal(vel, ref.vel.numpy())
    assert np.array_equal(mass, ref.mass.numpy())


def test_same_seed_same_inputs():
    a = plummer.make(2000, 5, 0.5, device="cpu")
    b = plummer.make(2000, 5, 0.5, device="cpu")
    c = plummer.make(2000, 6, 0.5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_plummer_follows_the_model():
    n, a, g, cut = 100_000, 728.0, 0.5, 0.999
    pos, vel, mass = (x.to(torch.float64) for x in plummer.make(
        n, 2**31 + 3, g, device="cpu", scale_radius=a, mass_cut=cut))
    m_tot = float(mass.sum())
    assert 2.0 <= float(mass.min()) and float(mass.max()) < 7.0
    # centre of mass and momentum removed
    assert float((mass[:, None] * pos).sum(0).norm()) / m_tot < 1e-6
    assert float((mass[:, None] * vel).sum(0).norm()) / m_tot < 1e-9
    r = pos.norm(dim=1)
    # half-mass radius of the model cut at `cut`: M(<r)/M = cut / 2
    x = cut / 2
    r_half = a / math.sqrt(x ** (-2 / 3) - 1)
    order = torch.argsort(r)
    m_cum = torch.cumsum(mass[order], 0)
    r_half_s = float(r[order][torch.searchsorted(m_cum, 0.5 * m_tot)])
    assert abs(r_half_s / r_half - 1) < 0.02
    assert abs(r_half / a - 1.3036) < 1e-3
    # radial cut at M(<r)/M = cut: r = 38.7 a
    assert float(r.max()) <= a / math.sqrt(cut ** (-2 / 3) - 1) * (1 + 1e-9)
    # isotropic velocities: equal dispersions along the axes
    s = (mass[:, None] * vel ** 2).sum(0) / m_tot
    assert float(s.max() / s.min()) < 1.03
    # virial ratio 2K/|W| = 1, W from the unsoftened potential at 2048
    # sampled bodies, scaled by mass
    ke = 0.5 * float((mass * (vel ** 2).sum(1)).sum())
    gen = torch.Generator().manual_seed(1)
    rows = torch.randperm(n, generator=gen)[:2048]
    phi = torch.zeros(len(rows), dtype=torch.float64)
    for i in range(0, n, 20_000):
        d = (pos[None, i:i + 20_000] - pos[rows, None]).norm(dim=2)
        w = torch.where(d > 0, mass[None, i:i + 20_000] / d,
                        torch.zeros_like(d))
        phi -= g * w.sum(1)
    w_pot = 0.5 * float((mass[rows] * phi).sum()) * n / len(rows)
    assert abs(2 * ke / abs(w_pot) - 1) < 0.05
