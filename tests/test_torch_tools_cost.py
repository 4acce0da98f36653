"""The cost probes of nbody_tpu_torch.tools (prof_hotrate, prof_hotcfg,
prof_rebuild, prof_runner) against the same quantities computed here
through nbody_tpu's functions (use_pallas=False), on one disk galaxy made
from a numpy seed: rebuild counts, validity horizons, envelope horizons,
band demand and cell counts bit-identical; the times are only checked to
be positive (a CPU time says nothing about the card)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.models import simulation as jsim
from nbody_tpu.ops import cells as jcells, forces as jforces

from nbody_tpu_torch.convert import config_to_dict, state_from_numpy
from nbody_tpu_torch.init import disk_galaxy_msvc
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import bbox as tbbox, cells as tcells, \
    forces as tforces
from nbody_tpu_torch.tools import (common, prof_hotcfg, prof_hotrate,
                                   prof_rebuild, prof_runner)

torch.set_num_threads(2)

N = 2048
# prof_runner's own config at force_tile 128 (prof_hotrate's differs in
# its hold; the runner is the same code), plain versions
CFG = prof_runner.make_config(N).replace(force_tile=128, use_pallas=False)


def _jc(cfg):
    return JConfig(**dict(config_to_dict(cfg), use_pallas=False))


@functools.lru_cache(maxsize=None)
def _arrays(seed=9):
    st = disk_galaxy_msvc(N, seed=seed, device="cpu")
    acc = np.random.default_rng(seed).normal(0.0, 3000.0, (N, 3))
    return (st.pos.numpy(), st.vel.numpy(), st.mass.numpy(),
            acc.astype(np.float32))


def _state():
    return state_from_numpy(*_arrays(), device="cpu")


def _jstate(ts):
    from nbody_tpu.state import ParticleState as JState

    return JState(*(jnp.asarray(x.numpy()) for x in ts))


@functools.lru_cache(maxsize=None)
def _jrunner(jc, steps):
    return jax.jit(jsim.make_adaptive_runner(jc, steps, return_stats=True))


def _j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def _jbands(ps, ms, cs, tc, drift):
    """nbody_tpu's cell_band_lists on the port's cells, supers,
    super-supers and sub-spheres (stage by stage: the packages round the
    monopoles' sums in their own orders; see test_torch_tools_accuracy)."""
    lo, size = tbbox.bounding_cube(ps)
    cells = tcells.build_source_cells(
        cs, ps, ms, tc.force_tile, tc.g, tc.cell_capacity, lo, size,
        drift_sorted=drift, g2_factor=tc.g2_cap_factor, bits=tc.morton_bits)
    supers = tforces.make_supers(cells)
    ss = tforces.make_ss(supers, tc)
    subs = tforces.target_subspheres(ps, tc.force_tile, drift=drift,
                                     codes=cs, bits=tc.morton_bits)
    jc = _jc(tc)
    return jax.jit(lambda t, s2, s, c: jforces.cell_band_lists(
        t, s2, s, c, jc))(
        jforces.GroupInfo(*map(_j, subs)), jforces.Supers(*map(_j, ss)),
        jforces.Supers(*map(_j, supers)), jcells.SourceCells(*map(_j, cells)))


def _skins(ts, tc, k):
    """The port's adaptive_drift skins at k (as the tools make them),
    held to nbody_tpu's within 1e-6, with |v|, |a| and the sorted inputs."""
    ps, ms, cs, perm, _, size = common.sorted_padded(ts, tc)
    npad = ps.shape[0]
    v = common.norms_padded(ts.vel[perm], npad)
    a = common.norms_padded(ts.acc[perm], npad)
    d = tsim.adaptive_drift(v, a, cs, size, tc, k=k)
    jc = _jc(tc)
    jcs, jperm, _, jsize = jsim.sort_by_morton(jnp.asarray(ts.pos.numpy()),
                                               jc)
    jcs = jforces.pad_sorted(jnp.asarray(ts.pos.numpy())[jperm],
                             jnp.asarray(ts.mass.numpy())[jperm], jcs,
                             tc.force_tile)[2]
    want = jsim.adaptive_drift(_j(v), _j(a), jcs, jsize, jc, k=jnp.float32(k))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-6)
    return ps, ms, cs, v, a, d


# --- 11: prof_hotrate --------------------------------------------------------


def test_hotrate_matches_jax_runner():
    """One untimed and two timed 3-step run_scan calls, each on the last
    one's output, which the port's runner carries on: the timed calls'
    rebuilds and the final state equal those of the port's runner over
    the same chain.  Each call of that chain started again instead (on a
    copy of the state handed on, as nbody_tpu's runner starts every
    call) rebuilds as nbody_tpu's runner does from the same bodies; and
    the rate is positive."""
    ts = _state()
    got = prof_hotrate.sustained(ts, CFG, steps=3, reps=2)
    assert got["ms_per_step"] > 0
    assert got["steps_per_sec"] == pytest.approx(1e3 / got["ms_per_step"])
    run, jrun = tsim.make_adaptive_runner(CFG, 3, return_stats=True), \
        _jrunner(_jc(CFG), 3)
    restart = tsim.make_adaptive_runner(CFG, 3, return_stats=True)
    st, want = ts, 0
    for i in range(3):
        _, n_rb = jrun(_jstate(st))
        _, r_rb = restart(type(st)(*(x.clone() for x in st)))
        assert r_rb == int(n_rb), i
        st, t_rb = run(st)
        want += t_rb if i else 0
    assert got["rebuilds"] == want >= 1
    for a, b in zip(got["state"], st):
        assert torch.equal(a, b)
    assert "sustained hot" in prof_hotrate.report("hot", got)
    cfg = prof_hotrate.make_config(N, {"hold_farmid": 2})
    assert (cfg.rebuild_every, cfg.hold_farmid, cfg.check_overflow) == (
        16, 2, False)


# --- 12: prof_hotcfg ---------------------------------------------------------


def test_hotcfg_demand_caps_and_horizon_match_jax():
    """Demand quantiles (nbody_tpu's classification on the port's
    upstream at k = 16 skins), the validity horizon (nbody_tpu's
    validity_horizon on the port's |v|, |a| and skins) and the caps sized
    from the demand by the JAX tool's formula, all equal."""
    ts = _state()
    huge = CFG.replace(**prof_hotcfg.HUGE, skin_width_cap=1.5)
    ps, ms, cs, v, a, d = _skins(ts, huge, 16.0)
    bands = _jbands(ps, ms, cs, huge, d)
    got = prof_hotcfg.demand(ts, huge)
    for k, f in (("ss", "ss_cnt"), ("sup", "sup_cnt"), ("mid", "mid_cnt"),
                 ("cmid", "cmid_cnt"), ("near", "near_cnt"),
                 ("wins", "win_cnt")):
        xs = np.sort(np.asarray(getattr(bands, f)))
        assert (got[k]["p999"], got[k]["max"]) == (
            int(xs[int(0.999 * (len(xs) - 1))]), int(xs[-1])), k
        assert got[k]["mean"] == pytest.approx(float(xs.mean()), rel=1e-6)
    assert got["s_valid"] == int(jsim.validity_horizon(_j(v), _j(a), _j(d),
                                                       _jc(huge)))
    lo, size = tbbox.bounding_cube(ps)
    assert got["n_cells"] == int(tcells.build_source_cells(
        cs, ps, ms, huge.force_tile, huge.g, huge.cell_capacity, lo, size,
        g2_factor=huge.g2_cap_factor, bits=63).n_cells)

    def cap_of(mx, align=64):         # tools/_prof_hotcfg.py:84-86
        return -(-int(mx * 1.25 + 16) // align) * align

    caps = prof_hotcfg.caps_for(got)
    assert caps == dict(
        ss_cap=min(cap_of(got["ss"]["max"]), 1024),
        sup_cap=cap_of(got["sup"]["max"]), mid_cap=cap_of(got["mid"]["max"]),
        cmid_cap=cap_of(got["cmid"]["max"]),
        near_cap=cap_of(got["near"]["max"], 128),
        win_cap=max(512, cap_of(got["wins"]["max"])))
    r = prof_hotcfg.alpha_run(ts, CFG, 1.5, steps=2)
    assert r["caps"] == caps and r["rate"]["ms_per_step"] > 0
    assert r["table_gb"] == CFG.replace(**caps).table_bytes / 2**30
    assert "[alpha=1.5]" in prof_hotcfg.report(1.5, r)


# --- 14: prof_rebuild --------------------------------------------------------


def test_rebuild_phases_match_jax():
    """Every phase of the JAX tool timed; the classified band entries
    summed over tiles (nbody_tpu's classification on the port's upstream
    at k = 4 skins) and the cell count equal."""
    ts = _state()
    got = prof_rebuild.phases(ts, CFG, iters=1)
    assert list(got["ms"]) == ["sort", "perm gathers", "cells", "supers",
                               "supersupers", "subspheres", "classify",
                               "tables", "FULL build_bands"]
    assert all(t > 0 for t in got["ms"].values())
    ps, ms, cs, _, _, d = _skins(ts, CFG, 4.0)
    bands = _jbands(ps, ms, cs, CFG, d)
    assert got["band_sums"] == {
        k: int(jnp.sum(getattr(bands, f))) for k, f in (
            ("ss", "ss_cnt"), ("sup", "sup_cnt"), ("mid", "mid_cnt"),
            ("cmid", "cmid_cnt"), ("near", "near_cnt"), ("wins", "win_cnt"))}
    assert got["tiles"] == N // CFG.force_tile
    lo, size = tbbox.bounding_cube(ps)
    assert got["n_cells"] == int(tcells.build_source_cells(
        cs, ps, ms, CFG.force_tile, CFG.g, CFG.cell_capacity, lo, size,
        drift_sorted=d, g2_factor=CFG.g2_cap_factor, bits=63).n_cells)
    assert "classify" in prof_rebuild.report(got, "cpu")


# --- 15: prof_runner ---------------------------------------------------------


def test_runner_runs_and_rebuild_match_jax():
    """Each run's rebuild count equals nbody_tpu's make_adaptive_runner's
    from the same state, and the bare rebuild's s_valid and k_next equal
    nbody_tpu's _adaptive_rebuild_fn's; every time is the median of its
    repetitions."""
    ts = _state()
    got = prof_runner.closure(ts, CFG, steps=3, fit_steps=(5, 8))
    jc, js = _jc(CFG), _jstate(ts)
    assert list(got["runs"]) == [3, 5, 8]
    for s, r in got["runs"].items():
        assert r["rebuilds"] == int(_jrunner(jc, s)(js)[1]), s
        assert r["ms"] > 0
    pos, vel, mass, acc, orig = jsim._pad_cycle_state(js, CFG.force_tile)
    _, (s_valid, k_next) = jax.jit(jsim._adaptive_rebuild_fn(jc))(
        pos.reshape(-1), vel.reshape(-1), mass, acc.reshape(-1), orig,
        jnp.int32(CFG.rebuild_every))
    rb = got["rebuild"]
    assert (rb["s_valid"], rb["k_next"]) == (int(s_valid), int(k_next))
    assert rb["ms"] > 0
    assert set(got["fit"]) == {"x_ms", "y_ms", "c_ms", "step_ms", "rank",
                               "y_from"}
    # each run and the rebuild timed REPS times, the median kept; the
    # spread is that of the repetitions' own fits
    for r in (*got["runs"].values(), rb):
        assert len(r["ms_all"]) == prof_runner.REPS
        assert r["ms"] == float(np.median(r["ms_all"]))
    for k, (lo, hi) in got["spread"].items():
        assert lo <= hi, k


@pytest.mark.parametrize("n_rb", [[1, 3, 4], [2, 4, 8]])
def test_runner_fit(n_rb):
    """Three runs with independent rebuild counts give the exact x, y, c;
    rebuild counts proportional to the steps (every step a rebuild, as
    at the hot state) cannot separate x from y, so y is the bare
    rebuild's time and x, c are fitted."""
    x, y, c = 2.5, 40.0, 7.0
    runs = {s: {"ms": x * s + y * k + c, "rebuilds": k}
            for s, k in zip((8, 16, 32), n_rb)}
    f = prof_runner.fit(runs, y_bare=41.0)
    if n_rb == [1, 3, 4]:
        assert f["rank"] == 3 and f["y_from"] == "fit"
        np.testing.assert_allclose([f["x_ms"], f["y_ms"], f["c_ms"]],
                                   [x, y, c], rtol=1e-9)
    else:
        assert f["rank"] == 2 and f["y_from"] == "bare rebuild"
        assert f["y_ms"] == 41.0
        # total - 41 k = (x - 1/4) s + c when k = s / 4
        np.testing.assert_allclose([f["x_ms"], f["c_ms"]], [x - 0.25, c],
                                   rtol=1e-9)
        assert f["step_ms"] == pytest.approx(x + y / 4, rel=1e-9)


# --- the whole upstream: nbody_tpu's own build on its own sorted inputs ------


def _jown_bands(ts, tc, k):
    """nbody_tpu's own build_bands of the bodies of `ts` (its Morton sort,
    adaptive_drift skins at k of its own sorted |v|, |a|, cut, monopoles,
    sub-spheres, classification): (cells, bands)."""
    js, jc = _jstate(ts), _jc(tc)
    cs, perm, _, size = jsim.sort_by_morton(js.pos, jc)
    ps, ms, cs = jforces.pad_sorted(js.pos[perm], js.mass[perm], cs,
                                    tc.force_tile)
    npad = ps.shape[0]

    def norms(x):
        v = jnp.sqrt(jnp.sum(x[perm] ** 2, axis=1))
        return jnp.pad(v, (0, npad - v.shape[0]))

    d = jsim.adaptive_drift(norms(js.vel), norms(js.acc), cs, size, jc,
                            k=jnp.float32(k))
    cells, _, bands, _ = jax.jit(lambda p, m, c, dr: jforces.build_bands(
        p, m, c, jc, drift=dr))(ps, ms, cs, d)
    return cells, bands


@pytest.mark.parametrize("tool", ["hotcfg", "rebuild"])
def test_cost_counts_match_jax_full_build(tool):
    """prof_hotcfg's demand (k = 16 skins, huge caps) and prof_rebuild's
    band sums (k = 4) equal those of nbody_tpu's own full build on its
    own sorted inputs bit for bit (p999, maxima, sums, cell counts),
    means within 1e-6: on this seed the two builds agree at every tile
    (test_torch_tools_accuracy.py shows a MAC tie where they do not)."""
    ts = _state()
    names = (("ss", "ss_cnt"), ("sup", "sup_cnt"), ("mid", "mid_cnt"),
             ("cmid", "cmid_cnt"), ("near", "near_cnt"), ("wins", "win_cnt"))
    if tool == "hotcfg":
        huge = CFG.replace(**prof_hotcfg.HUGE, skin_width_cap=1.5)
        cells, bands = _jown_bands(ts, huge, 16.0)
        got = prof_hotcfg.demand(ts, huge)
        for k, f in names:
            xs = np.sort(np.asarray(getattr(bands, f)))
            assert (got[k]["p999"], got[k]["max"]) == (
                int(xs[int(0.999 * (len(xs) - 1))]), int(xs[-1])), k
            assert got[k]["mean"] == pytest.approx(float(xs.mean()),
                                                   rel=1e-6)
    else:
        cells, bands = _jown_bands(ts, CFG, 4.0)
        got = prof_rebuild.phases(ts, CFG, iters=1)
        assert got["band_sums"] == {k: int(jnp.sum(getattr(bands, f)))
                                    for k, f in names}
    assert got["n_cells"] == int(cells.n_cells)
