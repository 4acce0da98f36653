"""nbody_tpu_torch's band-reuse runners against nbody_tpu's: the skin and
horizon stages and one adaptive rebuild on the JAX package's own
upstream outputs, the moment refresh, the adaptive runner end to end,
the fixed-K cycle runner, the stepper, run_scan's dispatch and the drift
protocol."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_jax
from nbody_tpu.models import simulation as jsim
from nbody_tpu.ops import forces as jforces
from nbody_tpu.state import ParticleState as JState
from nbody_tpu.utils import metrics as jmetrics

from nbody_tpu_torch.convert import config_from_dict, state_from_numpy
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import forces as tforces
from nbody_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

# the caps of tests/test_simulation.py's runner tests
BASE = dict(n=2048, force_tile=256, use_pallas=False, sup_cap=64,
            mid_cap=256, cmid_cap=512, near_cap=512, check_overflow=False)
# the sweeps tests' tolerance for far+mid on the same band structures
TOL = dict(rtol=2e-5, atol=2e-4)
# Trajectories: the port sums each sweep's float32 terms in float64, the
# JAX package in float32, so accelerations differ by float32 rounding of
# the cancelled band terms (~1e-3 of the total at some bodies, PERF.md);
# over 13 steps of dt 0.02 at coordinates ~1e3 that moves positions by
# ~1e-4 (measured max 1.2e-4) and velocities by ~1e-6.
TRAJ = dict(rtol=1e-5, atol=1e-3)


def _pair(**kw):
    jc = JConfig(**kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _t(x):
    a = np.asarray(x)
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def _key(codes):
    """The JAX package's sorted codes as the port's int64 keys."""
    c = np.asarray(codes).astype(np.int64)
    if c.ndim == 2:
        c = (c[:, 0] << 32) | c[:, 1]
    return torch.from_numpy(c)


def _tstate(js):
    return state_from_numpy(*(np.asarray(x) for x in js))


def _galaxy(n, seed, g=0.5, acc_scale=3000.0):
    """A disk galaxy with random accelerations (the IC's are zero)."""
    st = disk_galaxy_jax(n, seed=seed, g=g)
    acc = np.random.default_rng(seed).normal(0.0, acc_scale, (n, 3))
    return JState(pos=st.pos, vel=st.vel, mass=st.mass,
                  acc=jnp.asarray(acc.astype(np.float32)))


def _norms(x):
    return jnp.sqrt(jnp.sum(x * x, axis=1))


@pytest.fixture(scope="module", params=[30, 63])
def sorted_galaxy(request):
    """A Morton-sorted disk galaxy at one code width with its speed and
    acceleration magnitudes."""
    jc, tc = _pair(**BASE, morton_bits=request.param)
    st = _galaxy(jc.n, seed=3)
    codes, perm, _, size = jsim.sort_by_morton(st.pos, jc)
    v, a = _norms(st.vel[perm]), _norms(st.acc[perm])
    return dict(jc=jc, tc=tc, codes=codes, size=size, v=v, a=a)


# --- stages on the JAX package's upstream outputs ---------------------------


def test_local_width_bit_identical(sorted_galaxy):
    """The cell depths are identical and the port's widths are exactly
    box_size * 2^-depth; XLA's CPU exp2 lands a few ulps off the exact
    power of two (7 at depth 21), so the JAX widths are held to 1e-6."""
    r = sorted_galaxy
    want = np.asarray(jforces.local_width(r["codes"], r["size"],
                                          r["jc"].force_tile))
    got = tforces.local_width(_key(r["codes"]), _t(r["size"]),
                              r["tc"].force_tile, r["tc"].morton_bits).numpy()
    size = np.float32(r["size"])
    depth = -np.log2(got / size)
    np.testing.assert_array_equal(depth, np.rint(depth))
    np.testing.assert_array_equal(got, size * np.exp2(-depth).astype(
        np.float32))
    np.testing.assert_array_equal(depth, np.rint(-np.log2(want / size)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(np.unique(depth)) > 3


@pytest.mark.parametrize("clamp", [True, False])
def test_drift_bound_and_adaptive_drift_match(sorted_galaxy, clamp):
    r = sorted_galaxy
    jc, tc = r["jc"].replace(clamp_speed=clamp), r["tc"].replace(
        clamp_speed=clamp)
    v, a = _t(r["v"]), _t(r["a"])
    for k in (1, 16):
        np.testing.assert_allclose(
            tsim.drift_bound(v, a, tc, k).numpy(),
            np.asarray(jsim.drift_bound(r["v"], r["a"], jc, k)), rtol=1e-6)
    for k in (None, 5.0):
        jk = None if k is None else jnp.float32(k)
        tk = None if k is None else torch.tensor(k)
        want = jsim.adaptive_drift(r["v"], r["a"], r["codes"], r["size"], jc,
                                   k=jk)
        got = tsim.adaptive_drift(v, a, _key(r["codes"]), _t(r["size"]), tc,
                                  k=tk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("floor", [1, 2])
def test_validity_horizon_equal(sorted_galaxy, clamp, floor):
    r = sorted_galaxy
    jc = r["jc"].replace(clamp_speed=clamp, horizon_floor=floor,
                         rebuild_every=64)
    tc = r["tc"].replace(clamp_speed=clamp, horizon_floor=floor,
                         rebuild_every=64)
    seen = set()
    for k, scale in ((16.0, 1.0), (4.0, 1.0), (16.0, 10.0), (4.0, 100.0),
                     (16.0, 1000.0)):
        drift = jsim.adaptive_drift(r["v"], r["a"], r["codes"], r["size"], jc,
                                    k=jnp.float32(k)) * scale
        want = int(jsim.validity_horizon(r["v"], r["a"], drift, jc))
        got = tsim.validity_horizon(_t(r["v"]), _t(r["a"]), _t(drift), tc)
        assert got.dtype == torch.int64 and got.ndim == 0
        assert int(got) == want
        seen.add(want)
    assert len(seen) > 1         # the cases reach different horizons


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hold_predict_pos_matches(mode):
    rng = np.random.default_rng(mode)
    p, v, a = (rng.normal(0, s, (500, 3)).astype(np.float32)
               for s in (1000.0, 300.0, 5000.0))
    jc, tc = _pair(n=500, hold_predict=mode)
    want = jsim.hold_predict_pos(*(jnp.asarray(x) for x in (p, v, a)), 0.07,
                                 jc)
    got = tsim.hold_predict_pos(*(torch.from_numpy(x) for x in (p, v, a)),
                                0.07, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --- one adaptive rebuild ----------------------------------------------------

REBUILD_CASES = {
    "caps": dict(BASE, n=2000, rebuild_every=16),
    # tiny caps: the skins overflow the band caps, so k_next halves
    "tiny_caps": dict(BASE, n=2000, rebuild_every=16, sup_cap=8, mid_cap=16,
                      cmid_cap=16, near_cap=16),
}


@pytest.fixture(scope="module", params=sorted(REBUILD_CASES))
def rebuilt(request):
    """One JAX rebuild from a padded disk galaxy, k_env = 16."""
    jc, tc = _pair(**REBUILD_CASES[request.param])
    st = _galaxy(jc.n, seed=5)
    pos, vel, mass, acc, orig = jsim._pad_cycle_state(st, jc.force_tile)
    flat = [x.reshape(-1) for x in (pos, vel)] + [mass, acc.reshape(-1), orig]
    built, (s_valid, k_next) = jax.jit(jsim._adaptive_rebuild_fn(jc))(
        *flat, jnp.int32(16))
    tpos, tvel, tmass, tacc, torig = tsim._pad_cycle_state(_tstate(st),
                                                           tc.force_tile)
    np.testing.assert_array_equal(torig.numpy(), np.asarray(orig))
    fields, tbuilt, (ts_valid, tk_next) = tsim._adaptive_rebuild_fn(tc)(
        tpos, tvel, tmass, tacc, torig, torch.tensor(16))
    return dict(name=request.param, jc=jc, tc=tc, built=built,
                s_valid=int(s_valid), k_next=int(k_next), fields=fields,
                tbuilt=tbuilt, ts_valid=ts_valid, tk_next=tk_next)


def test_adaptive_rebuild_matches(rebuilt):
    r = rebuilt
    jpos, jvel, jmass, jacc, jorig, jsupers, jbands, jtables, jrctx = \
        r["built"]
    pos, vel, mass, acc, orig, afm = r["fields"]
    assert afm is None
    for got, want in ((pos, jpos), (vel, jvel), (acc, jacc)):
        np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(mass.numpy(), np.asarray(jmass))
    np.testing.assert_array_equal(orig.numpy(), np.asarray(jorig))
    cells, supers, bands, tables, rctx = r["tbuilt"]
    assert int(supers.n_supers) == int(jsupers.n_supers)
    assert (int(cells.n_cells) + 63) // 64 == int(supers.n_supers)
    np.testing.assert_array_equal(rctx[0].numpy(), _key(jrctx[0]).numpy())
    np.testing.assert_allclose(rctx[1].numpy(), np.asarray(jrctx[1]),
                               rtol=1e-6)
    for name in bands._fields:
        np.testing.assert_array_equal(getattr(bands, name).numpy(),
                                      np.asarray(getattr(jbands, name)),
                                      err_msg=name)
    for name in ("row_cnt", "near_cnt"):
        np.testing.assert_array_equal(getattr(tables, name).numpy(),
                                      np.asarray(getattr(jtables, name)))
    assert int(r["ts_valid"]) == r["s_valid"]
    assert int(r["tk_next"]) == r["k_next"]
    overflow = any(bool(getattr(jbands, f"{k}_overflow"))
                   for k in ("ss", "sup", "mid", "cmid", "near"))
    assert overflow == (r["name"] == "tiny_caps")
    if overflow:
        assert r["k_next"] == 8                   # halved from k_env = 16


def test_refresh_farmid_matches(rebuilt):
    """Moments recomputed from perturbed live positions at the frozen
    cut, on the JAX rebuild's own codes, skins, box and bands."""
    r = rebuilt
    jpos, jvel, jmass, _, _, _, jbands, _, jrctx = r["built"]
    live = (np.asarray(jpos) + 3 * r["jc"].dt * np.asarray(jvel)).reshape(-1, 3)
    tgt = live + np.float32(0.5)
    want = jax.jit(lambda p, m, rc, b, q: jforces.refresh_farmid(
        p, m, *rc, b, r["jc"], tgt_pos=q))(jnp.asarray(live), jmass, jrctx,
                                           jbands, jnp.asarray(tgt))
    bands = r["tbuilt"][2]
    rctx = (_key(jrctx[0]),) + tuple(_t(x) for x in jrctx[1:])
    got = tforces.refresh_farmid(torch.from_numpy(live), _t(jmass), *rctx,
                                 bands, r["tc"], tgt_pos=torch.from_numpy(tgt))
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- the adaptive runner end to end -----------------------------------------

RUNNER_CASES = {
    # the setups of tests/test_simulation.py's stepper and span tests
    "hold4": dict(BASE, rebuild_every=16, hold_farmid=4),
    "span_age1_no_ss": dict(BASE, rebuild_every=8, hold_farmid=5,
                            farmid_span_rebuilds=True, span_age_mult=1,
                            no_ss=True),
    "refresh_moments": dict(BASE, rebuild_every=16, hold_farmid=4,
                            refresh_moments=True),
}


@pytest.fixture(scope="module", params=sorted(RUNNER_CASES))
def jax_runner(request):
    """One 13-step JAX adaptive run per configuration."""
    jc, tc = _pair(**RUNNER_CASES[request.param])
    st = disk_galaxy_jax(jc.n, seed=7, g=jc.g)
    out, n_rb = jax.jit(jsim.make_adaptive_runner(jc, 13,
                                                  return_stats=True))(st)
    return dict(jc=jc, tc=tc, state=st, out=out, n_rb=int(n_rb))


def test_adaptive_runner_matches_jax_runner(jax_runner):
    r = jax_runner
    out, n_rb = tsim.make_adaptive_runner(r["tc"], 13, return_stats=True)(
        _tstate(r["state"]))
    assert n_rb == r["n_rb"]
    np.testing.assert_array_equal(out.mass.numpy(),
                                  np.asarray(r["state"].mass))
    moved = np.linalg.norm(np.asarray(r["out"].pos)
                           - np.asarray(r["state"].pos), axis=1)
    assert np.median(moved) > 0.5
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(r["out"].pos),
                               **TRAJ)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(r["out"].vel),
                               **TRAJ)


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_stepper_matches_port_runner(case):
    """The stepper split over (5, 5, 3) calls runs the runner's schedule:
    the same rebuilds and the same trajectory, bit for bit."""
    _, tc = _pair(**RUNNER_CASES[case])
    st = _tstate(disk_galaxy_jax(tc.n, seed=7, g=tc.g))
    want, n_rb = tsim.make_adaptive_runner(tc, 13, return_stats=True)(st)
    stepper = tsim.Simulation(tc, device="cpu").make_stepper(st)
    for k in (5, 5, 3):
        stepper.advance(k)
    assert stepper.steps_done == 13
    assert stepper.n_rebuilds == n_rb
    got = stepper.snapshot()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert stepper.pos_sorted.shape[0] % tc.force_tile == 0


# --- the fixed-K cycle runner ------------------------------------------------


@pytest.mark.parametrize("hold", [1, 2])
def test_cycle_runner_remainder_and_padding_matches_jax(hold):
    """n not a multiple of force_tile and 6 steps at K = 4 (one cycle and
    a 2-step remainder cycle), as tests/test_simulation.py's cycle test."""
    jc, tc = _pair(n=1000, force_tile=256, use_pallas=False, sup_cap=32,
                   mid_cap=128, cmid_cap=256, near_cap=256, rebuild_every=4,
                   hold_farmid=hold, adaptive_rebuild=False,
                   check_overflow=False)
    st = disk_galaxy_jax(jc.n, seed=7, g=jc.g)
    want = jsim.Simulation(jc, method="barnes_hut").run_scan(st, 6)
    got = tsim.Simulation(tc, device="cpu").run_scan(_tstate(st), 6)
    assert got.pos.shape == (1000, 3)
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(st.mass))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **TRAJ)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), **TRAJ)


# --- run_scan, run and make_stepper dispatch ---------------------------------


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_run_scan_dispatch():
    _, base = _pair(n=600, force_tile=128, use_pallas=False, sup_cap=32,
                    mid_cap=128, cmid_cap=256, near_cap=256,
                    check_overflow=False)
    st = _tstate(_galaxy(600, seed=11, acc_scale=0.0))
    # direct, and per-step rebuilds: a loop of step
    for method, cfg in (("direct", base.replace(rebuild_every=16)),
                        ("barnes_hut", base)):
        sim = tsim.Simulation(cfg, method=method, device="cpu")
        assert _same(sim.run_scan(st, 2), sim.step(sim.step(st)))
        assert sim.make_stepper(st) is None
    # adaptive: the adaptive runner, its rebuilds counted
    cfg = base.replace(rebuild_every=8, hold_farmid=2)
    sim = tsim.Simulation(cfg, device="cpu")
    want, n_rb = tsim.make_adaptive_runner(cfg, 3, return_stats=True)(st)
    assert _same(sim.run_scan(st, 3), want)
    assert sim.n_rebuilds == n_rb >= 1
    assert isinstance(sim.make_stepper(st), tsim.AdaptiveStepper)
    # fixed K: whole cycles, then one cycle of the remainder
    cfg = base.replace(rebuild_every=4, adaptive_rebuild=False)
    sim = tsim.Simulation(cfg, device="cpu")
    want = tsim.make_cycle_runner(cfg, 1, 2)(
        tsim.make_cycle_runner(cfg, 1, 4)(st))
    assert _same(sim.run_scan(st, 6), want)
    assert sim.make_stepper(st) is None
    # run: chunks of callback_every through run_scan
    seen = []
    got = sim.run(st, 6, callback=lambda k, s: seen.append(k),
                  callback_every=4)
    assert seen == [4, 6]
    assert _same(got, sim.run_scan(sim.run_scan(st, 4), 2))
    with pytest.raises(ValueError, match="lies on"):
        tsim.Simulation(cfg, device="cuda").run_scan(st, 1)


# --- the drift protocol ------------------------------------------------------


def test_drift_protocol_matches_jax():
    jc, tc = _pair(n=1024, force_tile=128, use_pallas=False, sup_cap=32,
                   mid_cap=128, cmid_cap=256, near_cap=256,
                   check_overflow=False)
    st = disk_galaxy_jax(jc.n, seed=4, g=jc.g)
    want = jmetrics.drift_protocol(jsim.Simulation(jc), st, n_steps=5,
                                   chunk=2)
    logged = []
    got = tmetrics.drift_protocol(tsim.Simulation(tc, device="cpu"),
                                  _tstate(st), n_steps=5, chunk=2,
                                  log=lambda k, sec, s: logged.append(k))
    assert got["drift_steps"] == want["drift_steps"] == 6
    assert logged == [2, 4, 6]
    np.testing.assert_allclose(got["e0"], want["e0"], rtol=1e-5)
    np.testing.assert_allclose(got["e1"], want["e1"], rtol=1e-4)
    assert got["avg_steps_per_sec"] > 0 and got["hot_steps_per_sec"] > 0
    np.testing.assert_allclose(got["state"].pos.numpy(),
                               np.asarray(want["state"].pos), **TRAJ)
