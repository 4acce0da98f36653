"""The inner-step and cadence probes of nbody_tpu_torch.tools (prof_inner,
prof_cycle, prof_cadence, prof_view) against nbody_tpu's functions on
the same numpy inputs (use_pallas=False; the JAX tools are scripts).
Counts must be bit-identical; positions agree within rtol 1e-5 over a
few inner steps on the same bands and within the runner tests'
tolerance over whole runs (TRAJ); times are only checked to be positive
(a CPU time says nothing about the card)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.models import simulation as jsim
from nbody_tpu.ops import bbox as jbbox, forces as jforces, \
    integrate as jinteg, morton as jmorton
from nbody_tpu.state import ParticleState as JState

from nbody_tpu_torch.convert import config_to_dict, state_from_numpy
from nbody_tpu_torch.init import disk_galaxy_msvc
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import forces as tforces
from nbody_tpu_torch.tools import common, prof_cadence, prof_cycle, \
    prof_inner, prof_view

torch.set_num_threads(2)

N = 2048
# whole runs (test_torch_runner.py's TRAJ): the port sums each sweep's
# float32 terms in float64, the JAX package in float32
TRAJ = dict(rtol=1e-5, atol=1e-3)


def _jc(cfg):
    return JConfig(**dict(config_to_dict(cfg), use_pallas=False))


@functools.lru_cache(maxsize=None)
def _arrays(seed=4):
    st = disk_galaxy_msvc(N, seed=seed, device="cpu")
    acc = np.random.default_rng(seed).normal(0.0, 3000.0, (N, 3))
    return (st.pos.numpy(), st.vel.numpy(), st.mass.numpy(),
            acc.astype(np.float32))


def _state(seed=4):
    return state_from_numpy(*_arrays(seed), device="cpu")


def _j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


# --- prof_inner --------------------------------------------------------------

INNER_CFG = prof_inner.make_config(N).replace(force_tile=256,
                                              use_pallas=False)
INNER_STEPS = 3


@pytest.fixture(scope="module")
def inner_run():
    return prof_inner.inner(_state(), INNER_CFG, INNER_STEPS)


def test_inner_near_rows_match_a_jax_loop(inner_run):
    """`near only` and `near + integrate (held afm)` over 3 steps against
    the same loops of nbody_tpu's apply_near and integrate on the port's
    bands and held far+mid."""
    ts = _state()
    ps, ms, cs, perm, _, _ = common.sorted_padded(ts, INNER_CFG)
    _, supers, bands, tables = tforces.build_bands(ps, ms, cs, INNER_CFG)
    afm = jnp.asarray(tforces.apply_farmid(ps, supers, tables,
                                           INNER_CFG).numpy())
    jb = jforces.CellBands(*map(_j, bands))
    jc = _jc(INNER_CFG)
    npad = ps.shape[0]
    p0, m = jnp.asarray(ps.numpy()), jnp.asarray(ms.numpy())
    v = jnp.pad(jnp.asarray(ts.vel[perm].numpy()), ((0, npad - N), (0, 0)))
    near = jax.jit(lambda p: jforces.apply_near(p, p, m, jb, jc))
    p = p0
    for _ in range(INNER_STEPS):
        p = p + 1e-6 * near(p)
    np.testing.assert_allclose(inner_run["pos"]["near only"].numpy(),
                               np.asarray(p), rtol=1e-5)
    p = p0
    for _ in range(INNER_STEPS):
        a = afm + near(p)
        st = jinteg.integrate(JState(pos=p, vel=v, mass=m, acc=a), a, jc)
        p, v = st.pos, st.vel
    got = inner_run["pos"]["near + integrate (held afm)"].numpy()
    assert np.abs(got - ps.numpy()).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(p), rtol=1e-5)


def test_inner_rows_and_full_body(inner_run):
    """Every row timed, the flat-carry rows absent, and the full body
    stepped with exactly one rebuild (its first)."""
    r = inner_run
    assert list(r["ms_per_step"]) == list(prof_inner.ROWS)
    assert all(v > 0 for v in r["ms_per_step"].values())
    assert set(r["absent"]) == {"flat carries + reshapes",
                                "flat + refresh cond (R)"}
    assert r["rebuilds"] == 1
    assert torch.isfinite(r["pos"][prof_inner.FULL]).all()
    text = prof_inner.report(r)
    assert "full body (no rebuilds)" in text and "absent" in text
    one = prof_inner.inner(_state(), INNER_CFG, 2, rows=(prof_inner.FULL,))
    assert list(one["ms_per_step"]) == [prof_inner.FULL]


# --- prof_cycle --------------------------------------------------------------


def test_cycle_band_counts_match_jax_30bit():
    """The mean band counts of both builds equal nbody_tpu's build_bands'
    on its own 30-bit sort with the same skins (the port's, as numpy:
    each package's |v| may round its 3-term sum in its own order)."""
    cfg = prof_cycle.make_config(N, 4).replace(force_tile=128,
                                               use_pallas=False)
    ts = _state()
    r = prof_cycle.cycle(ts, cfg, iters=1)
    assert r["k"] == 4 and r["inner_ms_per_step"] * 4 == r["inner_ms"] > 0
    jc = _jc(cfg.replace(morton_bits=30))
    pos, vel, mass, _ = (jnp.asarray(x) for x in _arrays())
    lo, size = jbbox.bounding_cube(pos)
    jcs, perm = jmorton.morton_sort_30(jmorton.encode30(pos, lo, size))
    jps, jms, jcs = jforces.pad_sorted(pos[perm], mass[perm], jcs, 128)
    npad = jps.shape[0]
    v = torch.from_numpy(np.array(jnp.pad(vel[perm], ((0, npad - N),
                                                      (0, 0)))))
    dk = jnp.asarray((torch.sqrt((v * v).sum(1)) * cfg.dt * 4
                      * cfg.skin_safety).numpy())
    build = jax.jit(lambda p, m_, c, d: jforces.build_bands(p, m_, c, jc,
                                                           drift=d))
    for label, d in (("unskinned", jnp.zeros_like(dk)), ("skin(K=4)", dk)):
        _, _, jb, _ = build(jps, jms, jcs, d)
        for k, f in (("sup", "sup_cnt"), ("mid", "mid_cnt"),
                     ("cmid", "cmid_cnt"), ("near", "near_cnt"),
                     ("wins", "win_cnt")):
            want = float(np.asarray(getattr(jb, f)).astype(np.float64).mean())
            assert r["builds"][label]["counts"][k] == pytest.approx(
                want, rel=1e-6), (label, k)
    assert (r["builds"]["skin(K=4)"]["counts"]["near"]
            > r["builds"]["unskinned"]["counts"]["near"])
    assert "inner x4 stepped" in prof_cycle.report(r)


# --- prof_cadence ------------------------------------------------------------


def test_cadence_rebuilds_match_jax_runner():
    """The untimed call's rebuild count equals nbody_tpu's
    make_adaptive_runner's from the same IC.  The timed call, on the
    first call's output, is carried on by the port's runner: its count
    and state equal those of the port runner's same two calls bit for
    bit.  Started again instead (on a copy of that output), as nbody_tpu's
    runner starts every call, the second call rebuilds as nbody_tpu's
    second call does and lands within TRAJ of it."""
    cfg = prof_cadence.make_config(4, 2, 0.75, N).replace(
        force_tile=256, use_pallas=False, sup_cap=64, mid_cap=256,
        cmid_cap=512, near_cap=512)
    ts = _state()
    ts = ts._replace(acc=torch.zeros_like(ts.acc))
    r = prof_cadence.cadence(ts, cfg, steps=8)
    run = jax.jit(jsim.make_adaptive_runner(_jc(cfg), 8, return_stats=True))
    pos, vel, mass, _ = (jnp.asarray(x) for x in _arrays())
    out, rb_first = run(JState(pos=pos, vel=vel, mass=mass,
                               acc=jnp.zeros_like(pos)))
    out, rb = run(out)
    port = tsim.make_adaptive_runner(cfg, 8, return_stats=True)
    first, p_first = port(ts)
    carried, p_rb = port(first)
    again, a_rb = tsim.make_adaptive_runner(cfg, 8, return_stats=True)(
        type(first)(*(x.clone() for x in first)))
    assert r["rebuilds_first"] == p_first == int(rb_first) >= 2
    assert r["rebuilds"] == p_rb >= 1
    assert all(torch.equal(a, b) for a, b in zip(r["state"], carried))
    assert a_rb == int(rb) >= 2
    assert r["ms_per_step"] > 0 and r["cadence"] == 8 / r["rebuilds"]
    np.testing.assert_allclose(again.pos.numpy(), np.asarray(out.pos),
                               **TRAJ)
    assert "rebuilds / 8 steps" in prof_cadence.report("IC", r)


# --- prof_view ---------------------------------------------------------------


def test_view_publishes_frames_on_the_cpu():
    cfg = prof_view.make_config(N).replace(use_pallas=False)
    assert (cfg.rebuild_every, cfg.hold_farmid) == (16, 4)
    r = prof_view.view_rate(_state(), cfg, frames=2)
    assert r["frames"] >= 2 and r["fps"] > 0 and r["rebuilds"] >= 1
    assert "FPS" in prof_view.report(N, 1, r)
