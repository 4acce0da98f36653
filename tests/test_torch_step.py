"""The whole slice: one nbody_tpu_torch Barnes-Hut step against one
nbody_tpu Simulation.step (plain jnp forces) on the same particles, and
both against the direct sum."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.models.simulation import Simulation as JSimulation
from nbody_tpu.state import ParticleState as JState

from nbody_tpu_torch.convert import (config_from_dict, state_from_numpy,
                                     state_to_numpy)
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.models.simulation import Simulation, sort_by_morton
from nbody_tpu_torch.ops import forces

torch.set_num_threads(2)

CASES = {
    # the caps of tests/test_forces.py::test_grouped_matches_direct_...
    "n2048_t256": (2048, 4, dict(force_tile=256, sup_cap=32, mid_cap=256,
                                 cmid_cap=512, near_cap=512)),
    # force_tile 512 as in tests/test_forces.py::..._at_force_tile_512
    "n6000_t512": (6000, 3, dict(force_tile=512)),
}


def _numpy_direct(pos, mass, g, soft):
    p = np.asarray(pos, np.float64)
    m = np.asarray(mass, np.float64)
    d = p[None, :, :] - p[:, None, :]
    w = g * m[None, :] * ((d**2).sum(-1) + soft) ** -1.5
    np.fill_diagonal(w, 0.0)
    return (w[:, :, None] * d).sum(1)


EPS32 = float(np.finfo(np.float32).eps)


def _band_term_scale(pos, mass, cfg):
    """Per particle |far| + |table| + |near|, in the original order."""
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    codes, perm, _, _ = sort_by_morton(p, cfg)
    ps, ms, cs = forces.pad_sorted(p[perm], m[perm], codes, cfg.force_tile)
    _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    terms = (forces.far_sweep_torch(ps, ss, cfg),
             forces.table_sweep_torch(ps, tables, cfg),
             forces.near_correction_torch(ps, ps, ms, bands.win_first,
                                          bands.win_mask, bands.win_cnt, cfg))
    s = sum(t.norm(dim=1) for t in terms)[: pos.shape[0]]
    out = torch.empty_like(s)
    out[perm] = s
    return out.numpy()


def _rel(a, b):
    return np.linalg.norm(a - b, axis=1) / (np.linalg.norm(b, axis=1) + 1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax_step(case):
    n, seed, kw = CASES[case]
    # the clouds of tests/test_forces.py::_cloud, plus velocities
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    mass = rng.uniform(1.0, 5.0, n).astype(np.float32)
    vel = np.random.default_rng(seed + 100).uniform(-50, 50, (n, 3)).astype(
        np.float32)
    jc = JConfig(n=n, theta=0.5, use_pallas=False, **kw)
    tc = config_from_dict(dataclasses.asdict(jc))
    want = JSimulation(jc).step(JState.create(pos, vel, mass))
    acc_j = np.asarray(want.acc)

    outs = {}
    for use in (False, True):            # True: the kernel wrappers' CPU path
        sim = Simulation(tc.replace(use_pallas=use), device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # no overflow warning expected
            outs[use] = state_to_numpy(sim.step(state_from_numpy(pos, vel,
                                                                 mass)))
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)
    got_pos, got_vel, _, acc_t = outs[False]

    err = _rel(acc_t, acc_j)
    assert float(np.median(err)) < 1e-5, float(np.median(err))
    # max: 1e-3 relative, beyond float32 rounding of the band terms the
    # decomposition cancels (far + table can reach ~1e4 x the total; the
    # JAX step itself is then ~1e-3 off a float64 sum of its own bands)
    scale = _band_term_scale(pos, mass, tc)
    excess = np.linalg.norm(acc_t - acc_j, axis=1) - 8 * EPS32 * scale
    assert float((excess / np.linalg.norm(acc_j, axis=1)).max()) < 1e-3
    np.testing.assert_allclose(got_vel, np.asarray(want.vel), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got_pos, np.asarray(want.pos), rtol=1e-5,
                               atol=1e-3)
    ref = _numpy_direct(pos, mass, tc.g, tc.softening)
    assert float(np.median(_rel(acc_t, ref))) < 0.02


# the one-step first call of each path: the per-step rebuild, fixed-K
# cycles (a one-step remainder cycle) and the adaptive runner
FIRST_CALLS = {
    "step": ({}, lambda sim, st: sim.step(st)),
    "cycles": (dict(rebuild_every=4, adaptive_rebuild=False),
               lambda sim, st: sim.run_scan(st, 1)),
    "adaptive": (dict(rebuild_every=4, adaptive_rebuild=True),
                 lambda sim, st: sim.run_scan(st, 1)),
}


@pytest.mark.parametrize("path", sorted(FIRST_CALLS))
def test_first_step_warns_on_cell_overflow(monkeypatch, path):
    """The first build's flags warn, once; the warning needs no sort of
    its own: one Morton sort a band build (the adaptive runner redoes its
    overflowed first build at grown caps)."""
    # a uniform cube cut at depth 3 has 512 cells of ~39 bodies, above
    # the 384-cell capacity of factor 1 at force_tile 64
    n = 20_000
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    mass = np.ones(n, np.float32)
    over, call = FIRST_CALLS[path]
    tc = config_from_dict(dataclasses.asdict(
        JConfig(n=n, force_tile=64, cell_cap_factor=1, use_pallas=False,
                **over)))
    sim = Simulation(tc, device="cpu")
    st = state_from_numpy(pos, np.zeros_like(pos), mass)
    sorts = []

    def counted(*args, **kw):
        sorts.append(1)
        return sort_by_morton(*args, **kw)

    monkeypatch.setattr(tsim, "sort_by_morton", counted)
    with pytest.warns(RuntimeWarning, match=r"capacity overflow: n_cells=\d+ "
                      r"> cell_capacity=384"):
        call(sim, st)
    c = sim.counters()
    builds = c["builds"] + c["step_builds"]
    assert len(sorts) == builds == (2 if path == "adaptive" else 1)
    assert c["overflow_by_flag"]["cells"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the check runs once
        call(sim, st)
