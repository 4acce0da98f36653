"""nbody_tpu_torch against nbody_tpu: config, state, initial conditions,
integrator, bounding box, direct forces and metrics on the same numpy
inputs; the port's import isolation and its default device."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from nbody_tpu import config as jcfg_mod
from nbody_tpu import init as jinit
from nbody_tpu.ops import bbox as jbbox, forces as jforces, integrate as jinteg
from nbody_tpu.state import ParticleState as JState
from nbody_tpu.utils import metrics as jmetrics

from nbody_tpu_torch import config as tcfg_mod
from nbody_tpu_torch import init as tinit
from nbody_tpu_torch.convert import (config_from_dict, state_from_numpy,
                                     state_to_numpy)
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import bbox as tbbox, forces as tforces
from nbody_tpu_torch.ops import integrate as tinteg
from nbody_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    vel = rng.uniform(-300, 300, (n, 3)).astype(np.float32)
    mass = rng.uniform(1.0, 5.0, n).astype(np.float32)
    return pos, vel, mass


# --- (a) config -------------------------------------------------------------


def test_config_fields_and_defaults_equal():
    jf = {f.name: f for f in dataclasses.fields(jcfg_mod.SimConfig)}
    tf = {f.name: f for f in dataclasses.fields(tcfg_mod.SimConfig)}
    assert list(jf) == list(tf)
    assert dataclasses.asdict(jcfg_mod.SimConfig()) == dataclasses.asdict(
        tcfg_mod.SimConfig())


@pytest.mark.parametrize("name", sorted(jcfg_mod.PRESETS))
def test_config_presets_and_derived_sizes_equal(name):
    j, t = jcfg_mod.PRESETS[name], tcfg_mod.PRESETS[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert config_from_dict(dataclasses.asdict(j)) == t
    for prop in ("n_groups", "win_pieces", "win_cap_eff", "cell_capacity",
                 "table_bytes"):
        assert getattr(j, prop) == getattr(t, prop), prop


@pytest.mark.parametrize("bad", [
    dict(n=0), dict(morton_bits=32), dict(softening=0.0),
    dict(force_tile=96), dict(force_tile=192), dict(force_tile=2048),
    dict(adaptive_rebuild=False, rebuild_every=6, hold_farmid=4),
])
def test_config_checks_equal(bad):
    with pytest.raises(ValueError):
        jcfg_mod.SimConfig(**bad)
    with pytest.raises(ValueError):
        tcfg_mod.SimConfig(**bad)


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        config_from_dict({"n": 10, "not_a_field": 1})


# --- state and conversion ---------------------------------------------------


def test_state_round_trip_and_permute():
    pos, vel, mass = _cloud(100, seed=1)
    st = state_from_numpy(pos, vel, mass, device="cpu")
    back = state_to_numpy(st)
    for a, b in zip(back, (pos, vel, mass, np.zeros_like(pos))):
        np.testing.assert_array_equal(a, b)
    perm = np.random.default_rng(0).permutation(100)
    js = JState.create(pos, vel, mass).permute(jnp.asarray(perm))
    ts = st.permute(torch.as_tensor(perm))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.to("cpu").n == 100


# --- (b), (c) initial conditions -------------------------------------------


def test_msvc_stream_and_disk_galaxy_bit_exact():
    np.testing.assert_array_equal(tinit.msvc_rand_sequence(42, 12345),
                                  jinit.msvc_rand_sequence(42, 12345))
    j = jinit.disk_galaxy_msvc(5000, seed=42, g=0.5)
    t = tinit.disk_galaxy_msvc(5000, seed=42, g=0.5, device="cpu")
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ks(a, b):
    return scipy.stats.ks_2samp(np.asarray(a), np.asarray(b)).pvalue


@pytest.mark.parametrize("kind", ["disk_galaxy", "legacy_disk",
                                  "uniform_cube"])
def test_torch_generator_ics_match_in_distribution(kind):
    n = 20_000
    cfg_j = jcfg_mod.SimConfig(n=n, ic_kind=kind, ic_rng="jax", seed=3)
    cfg_t = tcfg_mod.SimConfig(n=n, ic_kind=kind, ic_rng="jax", seed=3)
    j = jinit.make_initial_state(cfg_j)
    t = tinit.make_initial_state(cfg_t, device="cpu")
    jp, jv, jm = (np.asarray(x) for x in j[:3])
    tp, tv, tm = (x.numpy() for x in t[:3])
    assert tp.shape == jp.shape and tp.dtype == np.float32
    samples = [tp[:, 0], tp[:, 2], np.hypot(tp[:, 0], tp[:, 1]), tv[:, 0],
               tv[:, 2], tm]
    refs = [jp[:, 0], jp[:, 2], np.hypot(jp[:, 0], jp[:, 1]), jv[:, 0],
            jv[:, 2], jm]
    for s, r in zip(samples, refs):
        if np.ptp(r) == 0:               # a constant field must match exactly
            np.testing.assert_array_equal(s, r)
        else:
            assert _ks(s, r) > 1e-4


# --- integrator, bbox, direct forces, metrics --------------------------------


@pytest.mark.parametrize("clamp", [True, False])
def test_integrate_matches(clamp):
    pos, vel, mass = _cloud(2000, seed=2)
    acc = np.random.default_rng(5).normal(0, 4000, (2000, 3)).astype(np.float32)
    cj = jcfg_mod.SimConfig(n=2000, clamp_speed=clamp)
    ct = tcfg_mod.SimConfig(n=2000, clamp_speed=clamp)
    j = jinteg.integrate(JState.create(pos, vel, mass), jnp.asarray(acc), cj)
    t = tinteg.integrate(state_from_numpy(pos, vel, mass), torch.as_tensor(acc),
                         ct)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-4)


def test_bounding_cube_matches():
    pos, _, _ = _cloud(3000, seed=3)
    lo_j, s_j = jbbox.bounding_cube(jnp.asarray(pos))
    lo_t, s_t = tbbox.bounding_cube(torch.as_tensor(pos))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    assert float(s_t) == float(s_j)


def test_direct_forces_and_direct_step_match():
    n = 1500
    pos, vel, mass = _cloud(n, seed=4)
    cj = jcfg_mod.SimConfig(n=n)
    ct = tcfg_mod.SimConfig(n=n)
    a_j = np.asarray(jforces.direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                           cj))
    a_t = tforces.direct_forces(torch.as_tensor(pos), torch.as_tensor(mass),
                                ct, block=256).numpy()
    np.testing.assert_allclose(a_t, a_j, rtol=1e-4, atol=1e-3)
    sim = Simulation(ct, method="direct", device="cpu")
    st = sim.step(state_from_numpy(pos, vel, mass))
    np.testing.assert_allclose(st.acc.numpy(), a_j, rtol=1e-4, atol=1e-3)


def test_metrics_match():
    pos, vel, mass = _cloud(1500, seed=6)
    cj = jcfg_mod.SimConfig(n=1500)
    ct = tcfg_mod.SimConfig(n=1500)
    js = JState.create(pos, vel, mass)
    ts = state_from_numpy(pos, vel, mass)
    np.testing.assert_allclose(float(tmetrics.kinetic_energy(ts)),
                               float(jmetrics.kinetic_energy(js)), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.potential_energy(ts, ct, 512)),
                               float(jmetrics.potential_energy(js, cj, 512)),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tmetrics.total_energy(ts, ct)),
                               float(jmetrics.total_energy(js, cj)), rtol=1e-4)
    np.testing.assert_allclose(tmetrics.momentum(ts).numpy(),
                               np.asarray(jmetrics.momentum(js)), rtol=1e-4,
                               atol=1.0)
    for a, b in zip(tmetrics.bounding_box(ts), jmetrics.bounding_box(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tmetrics.energy_drift(2.0, 2.5) == jmetrics.energy_drift(2.0, 2.5)


# --- (i), (j) isolation and device ------------------------------------------


def test_port_imports_neither_jax_nor_nbody_tpu():
    """Every module of the package, walked (not listed), and
    chip_smoke.py's imports."""
    code = (
        "import importlib, pkgutil, sys, nbody_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    nbody_tpu_torch.__path__, 'nbody_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'nbody_tpu_torch.tools.prof_mxu' in names, names\n"
        "assert 'nbody_tpu_torch.ops.cuda.panel' in names, names\n"
        "for mod in ('cli', '__main__', 'ops.tree', 'ops.compensated',\n"
        "            'native.runtime', 'native.build', 'utils.io',\n"
        "            'utils.profiling', 'viz.render', 'viz.viewer'):\n"
        "    assert 'nbody_tpu_torch.' + mod in names, (mod, names)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'nbody_tpu' or m.startswith('nbody_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_simulation_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg_mod.SimConfig(n=256)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cfg)
    assert Simulation(cfg, device="cpu").device.type == "cpu"
    assert Simulation(cfg, method="barnes_hut_reference",
                      device="cpu").method == "barnes_hut_reference"
    with pytest.raises(ValueError):
        Simulation(cfg, method="bogus", device="cpu")
