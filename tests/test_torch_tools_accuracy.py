"""The accuracy probes of nbody_tpu_torch.tools (prof_mkhot, prof_kilostep,
prof_fbias, prof_fbias_cpu, prof_capdemand, prof_latestate,
prof_tailtargets, prof_nearwin, prof_stale, prof_skinerr, prof_crash1m)
against the same quantities computed here through nbody_tpu's functions
(use_pallas=False; the JAX tools are scripts), on disk galaxies made
from numpy seeds.  Integer outputs must be bit-identical; each float's
tolerance is named where it is checked.  The band counts are held both
to nbody_tpu's classification on the port's upstream (stage by stage)
and to nbody_tpu's own whole build on its own sorted inputs; where the
whole builds part, test_skinned_build_parts_only_at_mac_ties shows the
cause is a MAC tie.
"""

import dataclasses
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import PRESETS as JPRESETS, SimConfig as JConfig
from nbody_tpu.models import simulation as jsim
from nbody_tpu.ops import bbox as jbbox, cells as jcells, forces as jforces, \
    morton as jmorton
from nbody_tpu.state import ParticleState as JState
from nbody_tpu.utils import io as jio, metrics as jmetrics

from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.convert import config_to_dict, state_from_numpy
from nbody_tpu_torch.init import disk_galaxy_msvc
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import bbox as tbbox, cells as tcells, \
    forces as tforces
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.tools import (
    prof_capdemand, prof_crash1m, prof_fbias, prof_fbias_cpu, prof_kilostep,
    prof_latestate, prof_mkhot, prof_nearwin, prof_skinerr, prof_stale,
    prof_tailtargets)
from nbody_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

N = 2048
# the tools' own configs at force_tile 128 (crash1m's and capdemand's
# base, with the build knobs the others share), plain versions
BASE = SimConfig(n=N, theta=0.5, force_tile=128, rebuild_every=16,
                 hold_farmid=4, use_pallas=False, check_overflow=False)
BIG = BASE.replace(**prof_capdemand.BIG)
# small near and window caps, so the at-cap shares and flags are not 0
TIGHT = BASE.replace(near_cap=24, win_cap=10, sup_cap=8, mid_cap=24)
# the packages' band forces differ by float32 rounding of cancelled band
# terms (test_torch_runner.py: 2e-5 of |a|, 2e-4 absolute), so a relative
# force error of one body moves by up to ~2e-5 between them
REL_ERR_ATOL = 5e-5
# trajectories (test_torch_runner.py's TRAJ)
TRAJ = dict(rtol=1e-5, atol=1e-3)


def _jc(cfg):
    return JConfig(**dict(config_to_dict(cfg), use_pallas=False))


@functools.lru_cache(maxsize=None)
def _arrays(n=N, seed=5):
    st = disk_galaxy_msvc(n, seed=seed, device="cpu")
    acc = np.random.default_rng(seed).normal(0.0, 3000.0, (n, 3))
    return (st.pos.numpy(), st.vel.numpy(), st.mass.numpy(),
            acc.astype(np.float32))


def _states(n=N, seed=5):
    a = _arrays(n, seed)
    return state_from_numpy(*a, device="cpu"), JState(*map(jnp.asarray, a))


@functools.lru_cache(maxsize=None)
def _jbuild(jc, with_drift):
    if with_drift:
        return jax.jit(lambda p, m, c, d: jforces.build_bands(p, m, c, jc,
                                                             drift=d))
    return jax.jit(lambda p, m, c: jforces.build_bands(p, m, c, jc))


@functools.lru_cache(maxsize=None)
def _japply(jc):
    return jax.jit(lambda p, m, s, b, t: jforces.apply_bands(p, m, s, b, t,
                                                             jc))


def _jsorted(js, jc, bits=63):
    """(ps, ms, cs, perm, lo, size) as the JAX tools make them."""
    if bits == 30:
        lo, size = jbbox.bounding_cube(js.pos)
        cs, perm = jmorton.morton_sort_30(jmorton.encode30(js.pos, lo, size))
    else:
        cs, perm, lo, size = jsim.sort_by_morton(js.pos, jc)
    ps, ms, csp = jforces.pad_sorted(js.pos[perm], js.mass[perm], cs,
                                     jc.force_tile)
    return ps, ms, csp, perm, lo, size


def _jnorms(x, perm, npad):
    v = jnp.sqrt(jnp.sum(x[perm] ** 2, axis=1))
    return jnp.pad(v, (0, npad - v.shape[0]))


def _jq(x):
    xs = np.sort(np.asarray(x))
    return {"mean": float(jnp.mean(jnp.asarray(x).astype(jnp.float32))),
            "p999": int(xs[int(0.999 * (xs.shape[0] - 1))]),
            "max": int(xs[-1])}


def _j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


@functools.lru_cache(maxsize=None)
def _jclassify(jc):
    return jax.jit(lambda t, ss, su, c: jforces.cell_band_lists(t, ss, su, c,
                                                                jc))


def _jbands(ps, ms, cs, tc, drift=None):
    """nbody_tpu's classification (cell_band_lists: band lists, counts,
    windows, lane masks, overflow flags) on the port's cells, supers,
    super-supers and target sub-spheres, and the port's cells.  Each
    package rounds the monopoles' sums in its own order, and a centre of
    mass an ulp apart can flip a MAC that sits on its threshold; so the
    classification is compared stage by stage (ROADMAP "How the port is
    checked"), on the same upstream floats."""
    lo, size = tbbox.bounding_cube(ps)
    cells = tcells.build_source_cells(
        cs, ps, ms, tc.force_tile, tc.g, tc.cell_capacity, lo, size,
        drift_sorted=drift, g2_factor=tc.g2_cap_factor, bits=tc.morton_bits)
    supers = tforces.make_supers(cells)
    ss = tforces.make_ss(supers, tc)
    subs = tforces.target_subspheres(ps, tc.force_tile, drift=drift,
                                     codes=cs, bits=tc.morton_bits)
    jb = _jclassify(_jc(tc))(
        jforces.GroupInfo(*map(_j, subs)), jforces.Supers(*map(_j, ss)),
        jforces.Supers(*map(_j, supers)), jcells.SourceCells(*map(_j, cells)))
    return cells, jb


def _skins(ts, tc, js):
    """The tools' adaptive_drift skins (the port's, as numpy for the JAX
    build: each package's |v| rounds its 3-term sums in its own order,
    and a skin an ulp apart can flip a MAC), held to the JAX package's
    adaptive_drift within 1e-6."""
    ps, _, cs, perm, _, size = common.sorted_padded(ts, tc)
    npad = ps.shape[0]
    d = tsim.adaptive_drift(common.norms_padded(ts.vel[perm], npad),
                            common.norms_padded(ts.acc[perm], npad), cs,
                            size, tc)
    jc = _jc(tc)
    jps, _, jcs, jperm, _, jsize = _jsorted(js, jc)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    want = jsim.adaptive_drift(_jnorms(js.vel, jperm, npad),
                               _jnorms(js.acc, jperm, npad), jcs, jsize, jc)
    np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-6)
    return d


def _speeds30(ts, tc, clone):
    """The port's |v| in 30-bit Morton order as the tools pad it (zeros,
    or clones of the last row), for the JAX side's skins."""
    ps, _, _, perm, _, _ = prof_latestate.sorted30(ts, tc.force_tile)
    npad = ps.shape[0]
    v = (torch.sqrt((common.clone_padded(ts.vel[perm], npad) ** 2).sum(1))
         if clone else common.norms_padded(ts.vel[perm], npad))
    return perm.numpy(), jnp.asarray(v.numpy())


def _same_quantiles(got, want):
    assert (got["p999"], got["max"]) == (want["p999"], want["max"])
    assert got["mean"] == pytest.approx(want["mean"], rel=1e-6)


# --- 1, 2: prof_mkhot and prof_kilostep --------------------------------------


def test_kilostep_config_is_v5_bench_but_check_overflow():
    got = dataclasses.asdict(prof_kilostep.make_config(16, 8))
    for presets in (PRESETS, JPRESETS):
        want = dataclasses.asdict(presets["v5_bench"])
        assert {k for k in want if got[k] != want[k]} == {"check_overflow"}
    assert got["check_overflow"] is False


def _copy(state):
    return type(state)(*(x.clone() for x in state))


@pytest.fixture(scope="module")
def gate_runs():
    """prof_kilostep.gate and prof_mkhot.make_hot at N, 4 steps in
    2-step run_scan calls (the port's runner carries each call on from
    the last one's output), one 4-step port call, the port's drift
    protocol with each call handed a copy (so that it starts again, as
    nbody_tpu's run_scan starts every call), and the JAX drift protocol
    on one Simulation (its 2-step scan compiled once)."""
    tc = prof_kilostep.make_config(16, 8, N).replace(force_tile=128,
                                                     use_pallas=False)
    ts, js = _states()
    jsim_ = jsim.Simulation(_jc(tc))
    want = jmetrics.drift_protocol(jsim_, js, n_steps=4, chunk=2)
    lines = []
    got = prof_kilostep.gate(ts, tc, 4, chunk=2, log_every=2,
                             log=lines.append)
    hot = prof_mkhot.make_hot(ts, tc, 4, chunk=2, log=None)
    one = tsim.Simulation(tc, device="cpu").run_scan(ts, 4)
    sim = tsim.Simulation(tc, device="cpu")
    restarting = types.SimpleNamespace(
        cfg=tc, run_scan=lambda st, k: sim.run_scan(_copy(st), k))
    again = tmetrics.drift_protocol(restarting, ts, n_steps=4, chunk=2)
    jhot = jsim_.run_scan(jsim_.run_scan(js, 2), 2)
    return dict(want=want, got=got, lines=lines, hot=hot, jhot=jhot, tc=tc,
                one=one, again=again)


def test_kilostep_gate_matches_jax_drift_protocol(gate_runs):
    """The gate's chunks, carried on, end at the state of one 4-step call
    bit for bit.  Started again each chunk, as nbody_tpu's are, the
    protocol matches nbody_tpu's: E0 within 1e-5 and E1 within 1e-4
    relative (float32 sums of the softened energy in two orders), the
    final state within TRAJ."""
    got, want = gate_runs["got"], gate_runs["want"]
    again = gate_runs["again"]
    assert got["drift_steps"] == again["drift_steps"] == want[
        "drift_steps"] == 4
    assert all(torch.equal(a, b) for a, b in zip(got["state"],
                                                 gate_runs["one"]))
    np.testing.assert_allclose(got["e0"], want["e0"], rtol=1e-5)
    np.testing.assert_allclose(again["e1"], want["e1"], rtol=1e-4)
    assert got["e1"] == pytest.approx(float(tmetrics.total_energy(
        gate_runs["one"], gate_runs["tc"])), rel=1e-6)
    assert got["sim"].n_rebuilds >= 1
    assert got["ke"] == pytest.approx(float(tmetrics.kinetic_energy(
        gate_runs["one"])), rel=1e-6)
    np.testing.assert_allclose(again["state"].pos.numpy(),
                               np.asarray(want["state"].pos), **TRAJ)
    lines = gate_runs["lines"]
    assert lines[0].startswith("E0 = ") and len(lines) == 3
    assert lines[2].startswith("  4 steps")


def test_mkhot_state_matches_and_loads_in_jax(gate_runs, tmp_path):
    hot, jhot = gate_runs["hot"], gate_runs["jhot"]
    assert hot["steps"] == 4 and hot["rebuilds"] == \
        gate_runs["got"]["sim"].n_rebuilds
    for a, b in zip(hot["state"], gate_runs["got"]["state"]):
        assert torch.equal(a, b)            # the gate's run, bit for bit
    # calls started again on copies, as nbody_tpu's are
    np.testing.assert_allclose(gate_runs["again"]["state"].pos.numpy(),
                               np.asarray(jhot.pos), **TRAJ)
    path = str(tmp_path / "sub" / "hot.npz")
    prof_mkhot.save_hot(path, hot["state"], 4)
    loaded, step = jio.load_checkpoint(path)
    assert step == 4
    for a, b in zip(loaded, hot["state"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --- 3, 4: prof_fbias and prof_fbias_cpu --------------------------------------


def _jfbias(js, jc, a_ref):
    """The JAX tool's probe (tools/_prof_fbias.py:86-127)."""
    n = js.n
    ps, ms, cs, perm, _, _ = _jsorted(js, jc)
    cells, ss, bands, tables = _jbuild(jc, False)(ps, ms, cs)
    a_prod = _japply(jc)(ps, ms, ss, bands, tables)
    npad = ps.shape[0]
    vs = jnp.pad(js.vel[perm], ((0, npad - n), (0, 0)))
    ar = jnp.pad(a_ref[perm], ((0, npad - n), (0, 0)))
    da = a_prod - ar
    power = ms * jnp.sum(vs * da, axis=1)
    den = jnp.linalg.norm(ar, axis=1) + 1e-6
    rel = jnp.linalg.norm(da, axis=1) / den
    core = (den >= jnp.percentile(den[:n], 90.0)) & (jnp.arange(npad) < n)
    sp = jnp.linalg.norm(vs + a_prod * jc.dt, axis=1)
    over = sp > jc.max_speed
    q = jnp.percentile(rel[:n], jnp.float32([50., 90., 99.]))
    return {
        "p_err": float(jnp.sum(power)),
        "scale": float(jnp.sum(ms * jnp.linalg.norm(vs, axis=1)
                               * jnp.linalg.norm(ar, axis=1))),
        "rel_mean": float(jnp.mean(rel[:n])), "rel_max": float(
            jnp.max(rel[:n])),
        "n_clamp": int(jnp.sum(over)),
        "overflow": [bool(x) for x in (
            bands.ss_overflow, bands.sup_overflow, bands.mid_overflow,
            bands.cmid_overflow, bands.near_overflow, cells.overflow,
            cells.overflow_g2)],
        "n_cells": int(cells.n_cells),
        "p_core": float(jnp.sum(jnp.where(core, power, 0.0))),
        "rel_core": float(jnp.sum(jnp.where(core, rel, 0.0))
                          / jnp.sum(core)),
        "rel_halo": float(jnp.sum(jnp.where(core, 0.0, rel)[:n])
                          / (n - jnp.sum(core))),
        "q": [float(x) for x in q],
    }


def test_fbias_probe_matches_jax():
    """P_err and P_core within 1e-4 of sum m |v| |a| (the scale of the
    power terms, which cancel), the relative errors within REL_ERR_ATOL,
    the direct reference within 1e-5 of |a|, integers equal."""
    # a MAX_SPEED under the disk's fastest orbits, so the clamp term fires
    tc = prof_fbias.make_config(N).replace(force_tile=128, use_pallas=False,
                                           max_speed=10.0)
    jc = _jc(tc)
    ts, js = _states()
    a_ref = prof_fbias.direct_reference(ts, tc)
    ja_ref = jax.jit(lambda p, m: jforces.direct_forces(p, m, jc))(js.pos,
                                                                   js.mass)
    np.testing.assert_allclose(a_ref.numpy(), np.asarray(ja_ref), rtol=1e-5,
                               atol=1e-5 * float(jnp.max(jnp.abs(ja_ref))))
    want = _jfbias(js, jc, ja_ref)
    got = prof_fbias.probe(ts, tc, a_ref, e_tot=-1.0)
    assert got["rows"] == N
    assert list(got["overflow"].values()) == want["overflow"]
    assert (got["n_cells"], got["n_clamp"]) == (want["n_cells"],
                                                want["n_clamp"])
    assert want["n_clamp"] > 0               # the clamp term is exercised
    for k in ("p_err", "p_core"):
        assert abs(got[k] - want[k]) <= 1e-4 * want["scale"], k
    assert got["p_err"] == got["p_err_scaled"]
    assert got["de_128"] == pytest.approx(got["p_err"] * tc.dt * 128)
    for k, w in (("rel_mean", want["rel_mean"]), ("rel_max",
                 want["rel_max"]), ("rel_core", want["rel_core"]),
                 ("rel_halo", want["rel_halo"]), ("q50", want["q"][0]),
                 ("q90", want["q"][1]), ("q99", want["q"][2])):
        assert abs(got[k] - w) <= REL_ERR_ATOL, k
    # a sample of rows: the same sums over those bodies
    rows = torch.arange(0, N, 7)
    sub = prof_fbias.probe(ts, tc, prof_fbias.direct_reference(ts, tc, rows),
                           e_tot=-1.0, rows=rows)
    np.testing.assert_allclose(
        prof_fbias.direct_reference(ts, tc, rows).numpy(),
        a_ref[rows].numpy(), rtol=0, atol=0)
    assert sub["rows"] == len(rows)
    assert sub["p_err_scaled"] == pytest.approx(sub["p_err"] * N / len(rows))


def test_fbias_cpu_scan_matches_jax():
    """The float64 reference equal to the JAX tool's to 1e-12; per
    variant the error statistics within REL_ERR_ATOL."""
    tc = prof_fbias_cpu.make_config(N).replace(use_pallas=False)
    ts, js = _states()
    pos = np.asarray(js.pos, np.float64)
    mass = np.asarray(js.mass, np.float64)
    d = pos[None, :, :] - pos[:, None, :]
    w = tc.g * mass[None, :] * (np.sum(d * d, -1) + jforces.soft_term(
        _jc(tc))) ** -1.5
    a_true = np.sum(w[..., None] * d, axis=1)
    got_true = prof_fbias_cpu.direct_f64(ts, tc)
    np.testing.assert_allclose(got_true, a_true, rtol=1e-12)
    variants = ({}, {"theta": 0.3, "force_tile": 256})
    got = prof_fbias_cpu.scan(ts, tc, variants, a_true=got_true)
    for ov, g in zip(variants, got):
        jc = _jc(tc.replace(**ov))
        ps, ms, cs, perm, _, _ = _jsorted(js, jc)
        a = np.asarray(jax.jit(lambda p, m, c: jforces.bh_forces_grouped(
            p, m, c, jc))(ps, ms, cs))[:N]
        at = a_true[np.asarray(perm)]
        den = np.linalg.norm(at, axis=1) + 1e-12
        rel = np.linalg.norm(a - at, axis=1) / den
        halo = den <= np.percentile(den, 50)
        want = dict(rel_mean=rel.mean(), q50=np.percentile(rel, 50),
                    q90=np.percentile(rel, 90), q99=np.percentile(rel, 99),
                    halo_mean=rel[halo].mean(), core_mean=rel[~halo].mean())
        assert g["variant"] == ov
        for k, v in want.items():
            assert abs(g[k] - v) <= REL_ERR_ATOL, (ov, k)
    assert got[1]["rel_mean"] < got[0]["rel_mean"]     # θ 0.3 is tighter


# --- 5-8: demand, late state, tail targets, near windows ---------------------


_COUNTS = {"sup": "sup_cnt", "mid": "mid_cnt", "cmid": "cmid_cnt",
           "near": "near_cnt", "wins": "win_cnt"}


@pytest.mark.parametrize("skins", [True, False])
def test_capdemand_matches_jax(skins):
    """Quantiles of nbody_tpu's band counts (p999 and max equal, the
    mean within 1e-6) and the cut's counts of nbody_tpu's build."""
    ts, js = _states()
    ps, ms, cs, _, _, _ = common.sorted_padded(ts, BIG)
    d = _skins(ts, BIG, js) if skins else torch.zeros(ps.shape[0])
    _, bands = _jbands(ps, ms, cs, BIG, d)
    jps, jms, jcs, _, _, _ = _jsorted(js, _jc(BIG))
    jcells = _jbuild(_jc(BIG), True)(jps, jms, jcs, jnp.asarray(d.numpy()))[0]
    got = prof_capdemand.demand(ts, BIG, skins)
    for k, f in _COUNTS.items():
        _same_quantiles(got[k], _jq(getattr(bands, f)))
    assert (got["g2_overflow"], got["n_cells"], got["n_child"],
            got["n_g2"]) == (bool(jcells.overflow_g2), int(jcells.n_cells),
                             int(jcells.n_child), int(jcells.n_g2))
    assert "[IC]" in prof_capdemand.report("IC", got)


def test_latestate_matches_jax():
    """At TIGHT caps, so flags and at-cap shares fire; maxima, flags and
    the shares (counts over tiles) equal, means within 1e-6."""
    ts, js = _states()
    tc30 = TIGHT.replace(morton_bits=30)
    ps, ms, cs, perm, _, _ = prof_latestate.sorted30(ts, TIGHT.force_tile)
    _, _, _, jperm, _, _ = _jsorted(js, _jc(TIGHT), bits=30)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    v = common.norms_padded(ts.vel[perm], ps.shape[0])
    got = prof_latestate.late_state(ts, TIGHT)
    fired = set()
    for k in prof_latestate.KS:
        drift = np.minimum(v.numpy() * np.float32(TIGHT.dt) * np.float32(k)
                           * np.float32(TIGHT.skin_safety),
                           np.float32(TIGHT.max_speed * TIGHT.dt * k))
        if k == 1:
            drift = np.zeros_like(drift)
        _, bands = _jbands(ps, ms, cs, tc30, torch.from_numpy(drift))
        g = got[k]
        for b, f in _COUNTS.items():
            f = getattr(bands, f)
            assert g[b]["max"] == int(jnp.max(f)), (k, b)
            assert g[b]["mean"] == pytest.approx(float(jnp.mean(f)),
                                                 rel=1e-6)
        flags = {f: bool(getattr(bands, f"{f}_overflow"))
                 for f in ("sup", "mid", "cmid", "near")}
        assert g["overflow"] == flags
        assert g["near_at_cap"] == float(jnp.mean(
            (bands.near_cnt >= TIGHT.near_cap).astype(jnp.float32)))
        assert g["win_at_cap"] == float(jnp.mean(
            (bands.win_cnt >= bands.win_first.shape[1]).astype(jnp.float32)))
        fired |= {f for f, x in flags.items() if x}
        if g["near_at_cap"] > 0:
            fired.add("near_at_cap")
    assert {"near", "near_at_cap"} <= fired
    assert "K=16" in prof_latestate.report(16, got[16])


def test_tailtargets_matches_jax():
    """Integers equal; radii (nbody_tpu's target_subspheres) within 1e-6
    relative."""
    ts, js = _states()
    ps, ms, cs, _, _, size = common.sorted_padded(ts, BIG)
    _, bands = _jbands(ps, ms, cs, BIG)
    jps, _, jcs, _, _, _ = _jsorted(js, _jc(BIG))
    rad = np.asarray(jforces.target_subspheres(jps, BIG.force_tile,
                                               codes=jcs).radius).reshape(
        -1, jforces.SUB_FACTOR)
    sup, mid, near, wins = map(np.asarray, (bands.sup_cnt, bands.mid_cnt,
                                            bands.near_cnt, bands.win_cnt))
    got = prof_tailtargets.tail(ts, BIG, top=8)
    fat = rad.max(1) > float(size) / 16
    assert (got["fat"], got["fat_share"]) == (int(fat.sum()),
                                             float(fat.mean()))
    assert got["rad_max"] == pytest.approx(float(rad.max()), rel=1e-6)
    assert got["rad_p99"] == pytest.approx(
        float(np.percentile(rad.max(1), 99)), rel=1e-6)
    for label, arr in (("near", near), ("sup", sup), ("mid", mid)):
        order = np.argsort(-arr, kind="stable")[:8]
        assert [x["t"] for x in got["top"][label]] == order.tolist()
        for x, t in zip(got["top"][label], order):
            assert (x["sup"], x["mid"], x["near"], x["wins"]) == (
                sup[t], mid[t], near[t], wins[t])
            np.testing.assert_allclose(x["subrad"],
                                       np.sort(rad[t])[::-1][:4], rtol=1e-6)
    if (~fat).any():
        assert got["thin_near_max"] == int(near[~fat].max())
    assert "top near:" in prof_tailtargets.report(got)


@pytest.mark.parametrize("skins", [False, True])
def test_nearwin_window_counts_match_jax(skins):
    """Window and live-lane counts equal (nbody_tpu's masks' set bits
    over each tile's first win_cnt windows); the times are positive."""
    ts, js = _states()
    ps, ms, cs, _, _, _ = common.sorted_padded(ts, BIG)
    _, bands = _jbands(ps, ms, cs, BIG, _skins(ts, BIG, js) if skins
                       else None)
    wc = np.asarray(bands.win_cnt)
    masks = np.asarray(bands.win_mask).astype(np.uint32)
    bits = np.unpackbits(masks.view(np.uint8)).reshape(masks.shape + (32,))
    live = np.arange(masks.shape[-1])[None, None, :] < wc[:, None, None]
    lanes = int((bits.sum(-1) * live).sum())
    got = prof_nearwin.window_stats(ts, BIG, skins, iters=1)
    assert (got["windows"], got["live_lanes"]) == (int(wc.sum()), lanes)
    assert got["near_pairs"] == lanes * BIG.force_tile
    assert got["occupancy"] == lanes / (wc.sum() * 128)
    assert got["near_ms"] > 0 and got["farmid_ms"] > 0
    assert "occupancy" in prof_nearwin.report("x", got, "cpu")


# --- 9, 10: band reuse and skin error -----------------------------------------


def _rel(a, a_true):
    return (np.linalg.norm(a - a_true, axis=1)
            / (np.linalg.norm(a_true, axis=1) + 1e-6))


def _jcore(cs, size, jc, n):
    w = np.asarray(jforces.local_width(cs, size, jc.force_tile))[:n]
    return w < np.percentile(w, 10)


def test_stale_matches_jax():
    """After j = 1, 2 per-step steps (the port's, tested against JAX's in
    test_torch_step.py): nbody_tpu's frozen and refreshed S0 forces and
    fresh per-step forces at the port's stepped states, the JAX tool's
    construction; median, p95 and core median of the relative errors
    within REL_ERR_ATOL."""
    tc = TIGHT
    jc, jc30 = _jc(tc), _jc(tc.replace(morton_bits=30))
    ts, js = _states()
    ps0, ms, cs, perm, lo, size = _jsorted(js, jc, bits=30)
    npad = ps0.shape[0]
    _, v = _speeds30(ts, tc, clone=True)
    drift = jnp.minimum(v * jc.dt * 16 * jc.skin_safety,
                        jc.max_speed * jc.dt * 16)
    _, supers0, bands0, tables0 = _jbuild(jc30, True)(ps0, ms, cs, drift)
    core = _jcore(cs, size, jc, N)
    got = prof_stale.stale(ts, tc, js=(1, 2), k=16)
    w = np.asarray(jforces.local_width(cs, size, jc.force_tile))[:N]
    assert got["core_width"] == pytest.approx(float(np.median(w[core])))
    fresh = jax.jit(lambda p, m: jsim.compute_bh_acc(p, m, jc))
    refresh = jax.jit(lambda p: jforces.refresh_farmid(
        p, ms, cs, drift, lo, size, bands0, jc30)
        + jforces.apply_near(p, p, ms, bands0, jc30))
    sim = tsim.Simulation(tc, device="cpu")
    st = ts
    for j in (1, 2):
        st = sim.step(st)
        p_live = jnp.asarray(st.pos.numpy())[perm]
        p_live = jnp.concatenate([p_live, jnp.broadcast_to(
            p_live[-1], (npad - N, 3))])
        a_frozen = np.asarray(_japply(jc30)(p_live, ms, supers0, bands0,
                                            tables0))[:N]
        a_refresh = np.asarray(refresh(p_live))[:N]
        a_true = np.asarray(fresh(jnp.asarray(st.pos.numpy()),
                                  js.mass))[np.asarray(perm)]
        for name, a in (("frozen", a_frozen), ("refresh", a_refresh)):
            rel = _rel(a, a_true)
            g = got["j"][j][name]
            for k, x in (("med", np.median(rel)),
                         ("p95", np.percentile(rel, 95)),
                         ("core_med", np.median(rel[core]))):
                assert abs(g[k] - x) <= REL_ERR_ATOL, (j, name, k)
    assert "j= 2 refresh" in prof_stale.report(got)


def test_skinerr_matches_jax():
    """Window and near means and the flags (nbody_tpu's classification
    on the port's upstream) equal; the skin-induced error statistics of
    nbody_tpu's own builds within REL_ERR_ATOL."""
    tc = TIGHT
    jc30 = _jc(tc.replace(morton_bits=30))
    ts, js = _states()
    ps, ms, cs, perm, _, size = _jsorted(js, jc30, bits=30)
    tps, tms, tcs, _, _, _ = prof_latestate.sorted30(ts, tc.force_tile)
    _, v = _speeds30(ts, tc, clone=True)
    core = _jcore(cs, size, jc30, N)
    build, apply = _jbuild(jc30, True), _japply(jc30)
    _, su, bd, tb = build(ps, ms, cs, jnp.zeros_like(v))
    a_ref = np.asarray(apply(ps, ms, su, bd, tb))[:N]
    ks = (1, 16)
    got = prof_skinerr.skin_error(ts, tc, ks)
    for k in ks:
        drift = jnp.minimum(v * tc.dt * k * tc.skin_safety,
                            tc.max_speed * tc.dt * k)
        _, su, bd, tb = build(ps, ms, cs, drift)
        rel = _rel(np.asarray(apply(ps, ms, su, bd, tb))[:N], a_ref)
        _, bd = _jbands(tps, tms, tcs, tc.replace(morton_bits=30),
                        torch.from_numpy(np.array(drift)))
        g = got[k]
        assert g["wins"] == float(jnp.mean(bd.win_cnt))
        assert g["near"] == float(jnp.mean(bd.near_cnt))
        assert g["overflow"] == {f: bool(getattr(bd, f"{f}_overflow"))
                                 for f in ("near", "sup", "mid", "cmid")}
        for key, x in (("med", np.median(rel)), ("p95", np.percentile(rel, 95)),
                       ("core_p95", np.percentile(rel[core], 95))):
            assert abs(g[key] - x) <= REL_ERR_ATOL, (k, key)
    assert got[16]["p95"] > got[1]["p95"]
    assert "K=16" in prof_skinerr.report(16, got[16])


# --- 13: prof_crash1m ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _crash_chunk(seed=5):
    """prof_crash1m's 3-step chunk at BASE from the seed's state."""
    return prof_crash1m.chunk(_states(seed=seed)[0], BASE, 3)


def test_crash1m_chunk_matches_jax():
    """The chunk is the adaptive runner (its trajectory is held to JAX's
    in test_torch_runner.py): the same state and rebuild count.  Its
    diagnostics at that state: the band means and flags of nbody_tpu's
    classification on the port's upstream (means within 1e-6, flags
    equal), the cut's counts of nbody_tpu's build_source_cells."""
    ts, _ = _states()
    got = _crash_chunk()
    want, n_rb = tsim.make_adaptive_runner(BASE, 3, return_stats=True)(ts)
    assert all(torch.equal(a, b) for a, b in zip(got["state"], want))
    assert got["rebuilds"] == n_rb >= 1 and got["ms_per_step"] > 0
    ps, ms, cs, _, _, _ = common.sorted_padded(want, BASE)
    _, bands = _jbands(ps, ms, cs, BASE)
    lo, size = tbbox.bounding_cube(ps)
    jc = _jc(BASE)
    jcut = jax.jit(lambda c, p, m, lo_, sz: jcells.build_source_cells(
        c, p, m, jc.force_tile, jc.g, jc.cell_capacity, lo_, sz,
        g2_factor=jc.g2_cap_factor))(
        jnp.asarray(np.stack([cs.numpy() >> 32, cs.numpy() & 0xFFFFFFFF],
                             axis=1).astype(np.uint32)),
        _j(ps), _j(ms), _j(lo), _j(size))
    d = got["diagnostics"]
    assert (d["n_cells"], d["cell_overflow"], d["g2_overflow"]) == (
        int(jcut.n_cells), bool(jcut.overflow), bool(jcut.overflow_g2))
    assert d["n_supersupers"] == (int(jcut.n_cells) + 63) // 64
    for k in ("ss", "sup", "mid", "cmid", "near"):
        assert d[f"{k}_mean"] == pytest.approx(
            float(jnp.mean(getattr(bands, f"{k}_cnt"))), rel=1e-6), k
        assert d[f"{k}_overflow"] == bool(getattr(bands, f"{k}_overflow"))
    assert d["win_mean"] == pytest.approx(float(jnp.mean(bands.win_cnt)),
                                          rel=1e-6)
    assert "ovf c=0" in prof_crash1m.report(3, got)


# --- the whole upstream: nbody_tpu's own build on its own sorted inputs ------
#
# The tests above hand the port's cells, supers, super-supers and
# sub-spheres to nbody_tpu's classification.  Here nbody_tpu builds
# everything itself (its Morton sort, skins, cut, monopoles, sub-spheres
# and classification) from the same bodies, and the tools' integers must
# equal its counts bit for bit.  On these seeds the two builds agree at
# every tile; test_skinned_build_parts_only_at_mac_ties shows what a
# disagreement is where one occurs (seed 5, adaptive skins).


def _jown(js, tc, drift=None):
    """nbody_tpu's own build_bands of `js` at tc: (cells, bands).  drift:
    None, "adaptive" (adaptive_drift of its own sorted |v|, |a|) or a K
    (the older tools' capped skin of |v| for K steps, zero-padded, on
    30-bit codes)."""
    bits = 30 if isinstance(drift, int) else 63
    jc = _jc(tc.replace(morton_bits=bits))
    ps, ms, cs, perm, _, size = _jsorted(js, jc, bits=bits)
    npad = ps.shape[0]
    if drift is None:
        return _jbuild(jc, False)(ps, ms, cs)[0:3:2]
    if drift == "adaptive":
        d = jsim.adaptive_drift(_jnorms(js.vel, perm, npad),
                                _jnorms(js.acc, perm, npad), cs, size, jc)
    else:
        v = _jnorms(js.vel, perm, npad)
        d = jnp.minimum(v * jc.dt * drift * jc.skin_safety,
                        jc.max_speed * jc.dt * drift) if drift > 1 \
            else jnp.zeros_like(v)
    return _jbuild(jc, True)(ps, ms, cs, d)[0:3:2]


def _full_capdemand(seed, skins):
    ts, js = _states(seed=seed)
    cells, bands = _jown(js, BIG, "adaptive" if skins else None)
    got = prof_capdemand.demand(ts, BIG, skins)
    for k, f in _COUNTS.items():
        _same_quantiles(got[k], _jq(getattr(bands, f)))
    assert (got["g2_overflow"], got["n_cells"], got["n_child"],
            got["n_g2"]) == (bool(cells.overflow_g2), int(cells.n_cells),
                             int(cells.n_child), int(cells.n_g2))


def _full_nearwin(seed, skins):
    ts, js = _states(seed=seed)
    _, bands = _jown(js, BIG, "adaptive" if skins else None)
    wc = np.asarray(bands.win_cnt)
    masks = np.asarray(bands.win_mask).astype(np.uint32)
    bits = np.unpackbits(masks.view(np.uint8)).reshape(masks.shape + (32,))
    live = np.arange(masks.shape[-1])[None, None, :] < wc[:, None, None]
    got = prof_nearwin.window_stats(ts, BIG, skins, iters=1)
    assert (got["windows"], got["live_lanes"]) == (
        int(wc.sum()), int((bits.sum(-1) * live).sum()))


def _full_tailtargets(seed, _):
    ts, js = _states(seed=seed)
    _, bands = _jown(js, BIG)
    got = prof_tailtargets.tail(ts, BIG, top=8)
    sup, mid, near, wins = map(np.asarray, (bands.sup_cnt, bands.mid_cnt,
                                            bands.near_cnt, bands.win_cnt))
    for label, arr in (("near", near), ("sup", sup), ("mid", mid)):
        order = np.argsort(-arr, kind="stable")[:8]
        assert [x["t"] for x in got["top"][label]] == order.tolist()
        for x, t in zip(got["top"][label], order):
            assert (x["sup"], x["mid"], x["near"], x["wins"]) == (
                sup[t], mid[t], near[t], wins[t])


def _full_latestate(seed, _):
    ts, js = _states(seed=seed)
    got = prof_latestate.late_state(ts, TIGHT)
    for k in prof_latestate.KS:
        _, bands = _jown(js, TIGHT, k)
        g = got[k]
        for b, f in _COUNTS.items():
            assert g[b]["max"] == int(jnp.max(getattr(bands, f))), (k, b)
        assert g["overflow"] == {f: bool(getattr(bands, f"{f}_overflow"))
                                 for f in ("sup", "mid", "cmid", "near")}
        assert g["near_at_cap"] == float(jnp.mean(
            (bands.near_cnt >= TIGHT.near_cap).astype(jnp.float32)))
        assert g["win_at_cap"] == float(jnp.mean(
            (bands.win_cnt >= bands.win_first.shape[1]).astype(jnp.float32)))


def _full_crash1m(seed, _):
    """nbody_tpu's own build at the chunk's state against the tool's
    bh_diagnostics."""
    d = _crash_chunk(seed)
    cells, bands = _jown(JState(*(jnp.asarray(x.numpy())
                                  for x in d["state"])), BASE)
    got = d["diagnostics"]
    assert (got["n_cells"], got["cell_overflow"], got["g2_overflow"]) == (
        int(cells.n_cells), bool(cells.overflow), bool(cells.overflow_g2))
    for k in ("ss", "sup", "mid", "cmid", "near", "win"):
        assert got[f"{k}_mean"] == pytest.approx(
            float(jnp.mean(getattr(bands, f"{k}_cnt"))), rel=1e-6), k
        if k != "win":
            assert got[f"{k}_overflow"] == bool(getattr(bands,
                                                        f"{k}_overflow"))


@pytest.mark.parametrize("case,seed,skins", [
    ("capdemand", 5, False), ("capdemand", 1, True), ("nearwin", 5, False),
    ("nearwin", 1, True), ("tailtargets", 5, None), ("latestate", 1, None),
    ("crash1m", 5, None)])
def test_tool_counts_match_jax_full_build(case, seed, skins):
    """The tools' integers (demand p999 and maxima, cell counts, window
    and live-lane counts, the top tiles, flags and at-cap shares) equal
    those of nbody_tpu's own full build on its own sorted inputs, bit for
    bit; means within 1e-6."""
    globals()[f"_full_{case}"](seed, skins)


def _cmid_ratios(cells, subs, t, kid, soft):
    """(near test, cmid test) ratios of cell_band_lists' stage 3 for child
    `kid` against tile t's sub-spheres, in float32 from one package's
    cells and sub-spheres: the child fails when the first is >= theta and
    is refined to its grandchildren (cmid) when the second is < theta."""
    def a(x):
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)

    c, ch = divmod(kid, 8)
    com, sk = a(cells.child_com)[c, ch], a(cells.child_skin)[c, ch]
    gcom, gm = a(cells.gchild_com)[c, ch], a(cells.gchild_gmass)[c, ch]
    lo = np.where((gm > 0)[:, None], gcom, np.inf).min(0)
    hi = np.where((gm > 0)[:, None], gcom, -np.inf).max(0)
    ctr = a(subs.center).reshape(-1, 8, 3)[t]
    rad = (a(subs.radius) + a(subs.skin)).reshape(-1, 8)[t]

    def dist(p):
        gap = max(float((np.sqrt(((p - ctr) ** 2).sum(1)) - rad).min()), 0.0)
        gap = np.float32(max(gap - sk, 0.0))
        return np.sqrt(gap * gap + np.float32(soft))

    box = np.minimum(np.maximum(ctr, lo), hi)
    gap = max(float((np.sqrt(((box - ctr) ** 2).sum(1)) - rad).min()), 0.0)
    gap = np.float32(max(gap - sk, 0.0))
    dist_box = np.sqrt(gap * gap + np.float32(soft))
    return ((a(cells.child_diam)[c, ch] + 2 * sk) / dist(com),
            (a(cells.gchild_diam_max)[c, ch] + 2 * sk) / dist_box)


def test_skinned_build_parts_only_at_mac_ties():
    """Where the two packages' own builds disagree (seed 5, adaptive
    skins at BIG: one tile), the cause is a MAC tie.  Each package sums
    the grandchild monopoles in its own order, so the grandchild-COM box
    moves by an ulp; a child whose cmid test sits on theta then goes to
    cmid in one package and to near in the other.  Every other band and
    tile is equal; each flipped child's cmid ratio lies within 1e-5 of
    theta in both packages, on opposite sides."""
    tc = BIG
    jc = _jc(tc)
    ts, js = _states(seed=5)
    ps, ms, cs, perm, _, size = common.sorted_padded(ts, tc)
    npad = ps.shape[0]
    d = tsim.adaptive_drift(common.norms_padded(ts.vel[perm], npad),
                            common.norms_padded(ts.acc[perm], npad), cs,
                            size, tc)
    tcl, _, tb, _ = tforces.build_bands(ps, ms, cs, tc, drift=d)
    tsub = tforces.target_subspheres(ps, tc.force_tile, drift=d, codes=cs,
                                      bits=tc.morton_bits)
    jps, jms, jcs, jperm, _, jsize = _jsorted(js, jc)
    jd = jsim.adaptive_drift(_jnorms(js.vel, jperm, npad),
                             _jnorms(js.acc, jperm, npad), jcs, jsize, jc)
    jcl, _, jb, _ = _jbuild(jc, True)(jps, jms, jcs, jd)
    jsub = jforces.target_subspheres(jps, tc.force_tile, drift=jd, codes=jcs)
    for f in ("ss", "sup", "mid"):
        for x in ("cnt", "idx"):
            np.testing.assert_array_equal(getattr(tb, f"{f}_{x}").numpy(),
                                          np.asarray(getattr(jb, f"{f}_{x}")))

    def live(b, f, t):
        return set(np.asarray(getattr(b, f"{f}_idx"))[
            t, :int(getattr(b, f"{f}_cnt")[t])].tolist())

    tiles = np.nonzero((tb.cmid_cnt.numpy() != np.asarray(jb.cmid_cnt))
                       | (tb.near_cnt.numpy() != np.asarray(jb.near_cnt)))[0]
    assert len(tiles) == 1                      # this seed's one tie
    theta, soft = tc.theta, tforces.soft_term(tc)
    for t in tiles:
        t_cmid, j_cmid = live(tb, "cmid", t), live(jb, "cmid", t)
        flipped = t_cmid ^ j_cmid
        assert flipped
        assert live(tb, "near", t) ^ live(jb, "near", t) == flipped
        for kid in flipped:
            (tf, tr), (jf, jr) = (_cmid_ratios(cl, sub, t, kid, soft)
                                  for cl, sub in ((tcl, tsub), (jcl, jsub)))
            assert min(tf, jf) >= theta                 # fails in both
            assert abs(tr - theta) <= 1e-5 * theta
            assert abs(jr - theta) <= 1e-5 * theta
            assert (tr < theta) == (kid in t_cmid)      # opposite sides
            assert (jr < theta) == (kid in j_cmid)
