"""nbody_tpu_torch's rope-walk oracle against nbody_tpu: compensated
prefix sums, the escape-linearised tree, the per-particle walk, the
barnes_hut_reference step and the 63 -> 30-bit key truncation, on the
same numpy inputs (each stage gets the JAX package's upstream outputs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from nbody_tpu import config as jcfg
from nbody_tpu.init import disk_galaxy_msvc
from nbody_tpu.models import simulation as jsim
from nbody_tpu.ops import bbox as jbbox, compensated as jcomp
from nbody_tpu.ops import forces as jforces, morton as jmorton
from nbody_tpu.ops import tree as jtree
from nbody_tpu.state import ParticleState as JState

from nbody_tpu_torch import config as tcfg
from nbody_tpu_torch.convert import state_from_numpy
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import compensated as tcomp
from nbody_tpu_torch.ops import forces as tforces, tree as ttree

torch.set_num_threads(2)

INT_FIELDS = ("first", "last", "escape", "parent")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("n", [1000, 200_000])
def test_compensated_prefix_sums_match_jax_and_float64(n):
    """Double-float accuracy: every prefix within 1e-12 of the running sum
    of |x| of the float64 prefix (JAX's associative scan and the port's
    doubling scan add in different orders, so neither is bit-exact)."""
    x = np.random.default_rng(n).uniform(-5.0, 7.0, n).astype(np.float32)
    want = np.concatenate([[0.0], np.cumsum(x.astype(np.float64))])
    scale = np.concatenate([[1.0], np.cumsum(np.abs(x.astype(np.float64)))])
    th, tl = tcomp.prefix_sums(torch.as_tensor(x))
    jh, jl = jcomp.prefix_sums(jnp.asarray(x))
    got_t = th.double().numpy() + tl.double().numpy()
    got_j = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert np.max(np.abs(got_t - want) / scale) < 1e-12
    assert np.max(np.abs(got_t - got_j) / scale) < 1e-12
    # range sums over small ranges, collapsed to float32, as the tree uses
    f = np.arange(0, n - 40, 37)
    l = f + np.arange(len(f)) % 40
    rs_t = tcomp.range_sum(th, tl, torch.as_tensor(f), torch.as_tensor(l))
    rs_j = jcomp.range_sum(jh, jl, jnp.asarray(f), jnp.asarray(l))
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j), rtol=2e-7,
                               atol=1e-5)


def test_clz_every_bit_length():
    vals = [0]
    for k in range(32):
        vals += [1 << k, (1 << (k + 1)) - 1, (1 << k) | 1]
    x = np.array(vals, np.uint64)
    want = np.asarray(lax.clz(jnp.asarray(x.astype(np.uint32))))
    got = ttree._clz(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_inputs(case):
    """(sorted 30-bit codes uint32, pos_s, mass_s, size) from the JAX
    package; "dup" is a code array with heavy duplication."""
    if case == "dup":
        rng = np.random.default_rng(11)
        n = 300
        codes = np.sort(rng.integers(0, 40, n)).astype(np.uint32)
        pos = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
        mass = rng.uniform(1.0, 5.0, n).astype(np.float32)
        return codes, pos, mass, np.float32(256.0)
    n, clustered = case
    rng = np.random.default_rng(0)
    if clustered:
        centers = rng.uniform(-500, 500, (8, 3))
        pos = (centers[rng.integers(0, 8, n)]
               + rng.normal(0, 5, (n, 3))).astype(np.float32)
    else:
        pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    mass = rng.uniform(1.0, 5.0, n).astype(np.float32)
    lo, size = jbbox.bounding_cube(jnp.asarray(pos))
    sc, perm = jmorton.morton_sort_30(jmorton.encode30(jnp.asarray(pos), lo,
                                                       size))
    perm = np.asarray(perm)
    return np.asarray(sc), pos[perm], mass[perm], np.float32(size)


@pytest.mark.parametrize("case", [(2, False), (3, False), (64, False),
                                  (1000, True), (4096, True), "dup"])
def test_build_tree_matches_jax(case):
    """Integer fields bit-identical; width exact (a power-of-two scaling);
    mass and com within float32 rounding of the JAX tree's."""
    codes, pos_s, mass_s, size = _jax_inputs(case)
    jt = jtree.build_tree(jnp.asarray(codes), jnp.asarray(pos_s),
                          jnp.asarray(mass_s), jnp.float32(size))
    tt = ttree.build_tree(_t(codes.astype(np.int64)), _t(pos_s), _t(mass_s),
                          torch.tensor(size))
    assert tt.n_nodes == jt.n_nodes and tt.n_particles == jt.n_particles
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    np.testing.assert_array_equal(tt.width.numpy(), np.asarray(jt.width))
    np.testing.assert_allclose(tt.mass.numpy(), np.asarray(jt.mass),
                               rtol=3e-7)
    np.testing.assert_allclose(tt.com.numpy(), np.asarray(jt.com), rtol=3e-7,
                               atol=1e-4)


def test_bh_forces_reference_matches_jax():
    """The lockstep walk on the JAX tree of a 2048-body disk against the
    vmapped while_loop: per-body relative difference <= 1e-4 (float32
    terms summed in the same order; a com differing in its last bit may
    flip one accept decision)."""
    n = 2048
    st = disk_galaxy_msvc(n)
    cj = jcfg.SimConfig(n=n)
    ct = tcfg.SimConfig(n=n)
    codes, perm, _, size = jsim.sort_by_morton(st.pos, cj)
    codes30 = (codes[:, 0] >> 1) & jnp.uint32(0x3FFFFFFF)
    pos_s, mass_s = st.pos[perm], st.mass[perm]
    jt = jtree.build_tree(codes30, pos_s, mass_s, size)
    want = np.asarray(jforces.bh_forces_reference(pos_s, jt, cj))
    tt = ttree.LinearTree(*(_t(x) for x in jt))
    stats = {}
    got = tforces.bh_forces_reference(_t(pos_s), tt, ct, block=64,
                                      stats=stats).numpy()
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() <= 1e-4, rel.max()
    assert stats["iterations"] % 64 == 0 and stats["iterations"] > 64
    assert stats["host_reads"] == stats["iterations"] // 64


def test_reference_step_matches_jax():
    n = 1000
    st = disk_galaxy_msvc(n, seed=5)
    pos, vel, mass = (np.asarray(x) for x in st[:3])
    cj = jcfg.SimConfig(n=n)
    ct = tcfg.SimConfig(n=n)
    want = jsim.Simulation(cj, method="barnes_hut_reference").step(
        JState.create(pos, vel, mass))
    sim = tsim.Simulation(ct, method="barnes_hut_reference", device="cpu")
    got = sim.step(state_from_numpy(pos, vel, mass))
    a_j = np.asarray(want.acc)
    rel = (np.linalg.norm(got.acc.numpy() - a_j, axis=1)
           / np.linalg.norm(a_j, axis=1))
    assert rel.max() <= 1e-4, rel.max()
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=1e-5, atol=1e-4)
    assert sim.walk_stats["iterations"] > 0
    assert sim.walk_stats["host_reads"] >= 1
    assert sim.make_stepper(got) is None
    # run_scan of the reference method steps with a rebuild each step
    out = sim.run_scan(got, 2)
    assert torch.isfinite(out.pos).all()


def test_key_truncation_63_to_30_matches_jax():
    """(key >> 33) & 0x3FFFFFFF of the port's int64 63-bit key equals
    JAX's (hi >> 1) & 0x3FFFFFFF, and the trees built on them agree."""
    n = 4096
    st = disk_galaxy_msvc(n, seed=9)
    cj = jcfg.SimConfig(n=n)
    ct = tcfg.SimConfig(n=n)
    codes_j, perm_j, _, size = jsim.sort_by_morton(st.pos, cj)
    c30_j = np.asarray((codes_j[:, 0] >> 1) & jnp.uint32(0x3FFFFFFF))
    pos = _t(st.pos)
    codes_t, perm_t, _, size_t = tsim.sort_by_morton(pos, ct)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    c30_t = (codes_t >> 33) & 0x3FFFFFFF
    np.testing.assert_array_equal(c30_t.numpy(), c30_j.astype(np.int64))
    assert np.all(np.diff(c30_j.astype(np.int64)) >= 0)
    jt = jtree.build_tree(jnp.asarray(c30_j), st.pos[perm_j],
                          st.mass[perm_j], size)
    tt = ttree.build_tree(c30_t, pos[perm_t], _t(st.mass)[perm_t], size_t)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
