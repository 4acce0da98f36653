"""The rebuild's stage probes of nbody_tpu_torch.tools (prof_cells,
prof_groups, prof_classify) and the pack-stage A/B (prof_winmask) against
nbody_tpu's functions on the same numpy inputs (use_pallas=False; the
JAX tools are scripts).  Integer outputs must be bit-identical; the
float moments agree within float32 prefix-sum rounding (stated where
checked); times are only checked to be positive (a CPU time says
nothing about the card)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.models import simulation as jsim
from nbody_tpu.ops import bbox as jbbox, cells as jcells, forces as jforces, \
    morton as jmorton

from nbody_tpu_torch.convert import config_to_dict, state_from_numpy
from nbody_tpu_torch.init import disk_galaxy_msvc
from nbody_tpu_torch.ops import cells as tcells, forces as tforces
from nbody_tpu_torch.tools import common, prof_cells, prof_classify, \
    prof_groups, prof_winmask

torch.set_num_threads(2)

N = 2048


def _jc(cfg):
    return JConfig(**dict(config_to_dict(cfg), use_pallas=False))


@functools.lru_cache(maxsize=None)
def _arrays(seed=3):
    st = disk_galaxy_msvc(N, seed=seed, device="cpu")
    acc = np.random.default_rng(seed).normal(0.0, 3000.0, (N, 3))
    return (st.pos.numpy(), st.vel.numpy(), st.mass.numpy(),
            acc.astype(np.float32))


def _state(seed=3):
    return state_from_numpy(*_arrays(seed), device="cpu")


def _j(x):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def _key63(codes):
    c = np.asarray(codes).astype(np.int64)
    return (c[:, 0] << 32) | c[:, 1]


@functools.lru_cache(maxsize=None)
def _jclassify(jc):
    return jax.jit(lambda t, ss, su, c: jforces.cell_band_lists(t, ss, su, c,
                                                                jc))


def _jbands(tgt, ss, supers, cells, tc):
    """nbody_tpu's cell_band_lists on the port's upstream (stage by
    stage: each package rounds the monopoles' sums in its own order)."""
    return _jclassify(_jc(tc))(
        jforces.GroupInfo(*map(_j, tgt)), jforces.Supers(*map(_j, ss)),
        jforces.Supers(*map(_j, supers)), jcells.SourceCells(*map(_j, cells)))


# --- prof_cells --------------------------------------------------------------

CELLS_CFG = prof_cells.make_config(N).replace(force_tile=128,
                                              use_pallas=False)


@pytest.fixture(scope="module")
def cells_inputs():
    """The port's and nbody_tpu's sorted, tile-padded 63-bit inputs."""
    ts = _state()
    ps, ms, cs, perm, lo, size = common.sorted_padded(ts, CELLS_CFG)
    pos, _, mass, _ = (jnp.asarray(x) for x in _arrays())
    jcs, jperm, jlo, jsize = jsim.sort_by_morton(pos, _jc(CELLS_CFG))
    jps, jms, jcs = jforces.pad_sorted(pos[jperm], mass[jperm], jcs,
                                       CELLS_CFG.force_tile)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(cs.numpy(), _key63(jcs))
    return dict(t=(ps, ms, cs, lo, size), j=(jps, jms, jcs, jlo, jsize))


def test_cells_cut_scans_match_jax(cells_inputs):
    got = prof_cells.prefix("cut_scans", *cells_inputs["t"], CELLS_CFG)[0]
    jcs = cells_inputs["j"][2]
    want = jcells._sliding_cut_depth(jcells.adjacent_lcp(jcs),
                                     CELLS_CFG.force_tile,
                                     jcells.max_depth_of(jcs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cells_compacts_are_the_builds_runs(cells_inputs):
    """The compacted cell runs are the whole build's first/count, and
    nbody_tpu's build_source_cells' on the same sorted inputs, bit for
    bit; each level's ids end at its run count."""
    t, cfg = cells_inputs["t"], CELLS_CFG
    ps, ms, cs, lo, size = t
    n = cs.shape[0]
    edges = prof_cells.prefix("compacts", *t, cfg)
    ids = prof_cells.prefix("ids", *t, cfg)
    g_cap = cfg.cell_capacity
    assert [e.shape[0] for e in edges] == [
        g_cap + 1, 8 * g_cap + 1, min(cfg.g2_cap_factor, 8) * 8 * g_cap + 1]
    first = edges[0][:-1]
    count = torch.clamp(edges[0][1:] - first, 0, n)
    first = torch.where(count > 0, first, 0)
    full = prof_cells.prefix("full_noskin", *t, cfg)
    assert torch.equal(first, full.first) and torch.equal(count, full.count)
    for i, e in zip(ids, edges):
        assert int((e < n).sum()) == int(i[-1]) + 1
    jps, jms, jcs, jlo, jsize = cells_inputs["j"]
    want = jcells.build_source_cells(jcs, jps, jms, cfg.force_tile, cfg.g,
                                     g_cap, jlo, jsize,
                                     g2_factor=cfg.g2_cap_factor)
    np.testing.assert_array_equal(first.numpy(), np.asarray(want.first))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want.count))
    assert int(full.n_cells) == int(want.n_cells) > 8


def test_cells_moments_and_geometry(cells_inputs):
    """The moment sums of every run agree with nbody_tpu's float32 prefix
    sums within float32 rounding of a prefix (a run's sum is the
    difference of two prefixes of up to N terms: 4e-6 of the column's
    total); the analytic corners and widths are the whole build's."""
    t, cfg = cells_inputs["t"], CELLS_CFG
    n = t[2].shape[0]
    out = prof_cells.prefix("analytic", *t, cfg)
    moments, geometry = out[:3], out[3:]
    assert all(torch.equal(a, b) for a, b in zip(
        moments, prof_cells.prefix("moments", *t, cfg)))
    jps, jms, _, _, _ = cells_inputs["j"]
    pmw = np.asarray(jcells._cumsum_prefix(
        jnp.concatenate([jms[:, None], jps * jms[:, None]], axis=1)))
    scale = np.abs(pmw).max(axis=0)
    for e, got in zip(prof_cells.prefix("compacts", *t, cfg), moments):
        e = e.numpy()
        row = np.clip(e[:-1], 0, n - 1)
        count = np.clip(e[1:] - e[:-1], 0, n)
        want = pmw[np.clip(row + count, 0, n)] - pmw[row]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4e-6 * scale.max())
        assert got[:, 0].sum().item() == pytest.approx(
            float(t[1].to(torch.float64).sum()), rel=1e-12)
    full = prof_cells.prefix("full_noskin", *t, cfg)
    corner, width = geometry[0]
    valid = full.count > 0
    assert torch.equal(corner[valid], full.lo[valid])
    assert torch.equal(width[valid], full.diam[valid])
    skin = prof_cells.prefix("full_skin", *t, cfg)
    assert torch.equal(skin.first, full.first)
    assert float(skin.skin[valid].min()) == 1.0


def test_cells_stage_times():
    r = prof_cells.stage_times(_state(), CELLS_CFG, iters=1)
    assert list(r["ms"]) == list(prof_cells.STAGES)
    assert all(v > 0 for v in r["ms"].values()) and r["n_cells"] > 8
    ops = [r["ops"][s] for s in prof_cells.STAGES]
    assert ops[0] > 0 and ops[:-1] == sorted(ops[:-1])   # prefixes grow
    assert ops[-1] > ops[-2]                             # skins add ops
    assert "full_skin" in prof_cells.report(r)


# --- prof_groups -------------------------------------------------------------


def test_groups_phases_match_jax():
    """The 30-bit build with a uniform drift of 10: the cell count equals
    nbody_tpu's build on its own 30-bit sort, the band sums its
    classification of the port's upstream (built here as the tool does)."""
    cfg = prof_groups.make_config(N).replace(force_tile=128,
                                             use_pallas=False)
    assert (cfg.morton_bits, cfg.check_overflow) == (30, False)
    ts = _state()
    r = prof_groups.phases(ts, cfg, iters=1)
    assert list(r["ms"]) == ["cells", "supers", "supersupers", "subspheres",
                             "band_lists", "tables"]
    assert all(t["min_ms"] <= t["median_ms"] for t in r["ms"].values())
    pos, _, mass, _ = (jnp.asarray(x) for x in _arrays())
    jlo, jsize = jbbox.bounding_cube(pos)
    jcs, jperm = jmorton.morton_sort_30(jmorton.encode30(pos, jlo, jsize))
    jps, jms, jcs = jforces.pad_sorted(pos[jperm], mass[jperm], jcs, 128)
    jd = jnp.full((jps.shape[0],), prof_groups.DRIFT, jnp.float32)
    want = jcells.build_source_cells(jcs, jps, jms, 128, cfg.g,
                                     cfg.cell_capacity, jlo, jsize,
                                     drift_sorted=jd)
    assert r["n_cells"] == int(want.n_cells)
    ps, ms, cs, _, lo, size = common.sorted_padded(ts, cfg)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))
    d = torch.full((ps.shape[0],), prof_groups.DRIFT)
    cells = tcells.build_source_cells(cs, ps, ms, 128, cfg.g,
                                      cfg.cell_capacity, lo, size,
                                      drift_sorted=d, bits=30)
    supers = tforces.make_supers(cells)
    jb = _jbands(tforces.target_subspheres(ps, 128, drift=d),
                 tforces.make_supersupers(supers), supers, cells, cfg)
    assert r["band_sums"] == {k: int(np.asarray(getattr(jb, f)).sum())
                              for k, f in common.COUNTS.items()}
    assert r["band_sums"]["near"] > 0
    assert "band_lists" in prof_groups.report(r)


# --- prof_classify -----------------------------------------------------------

CLASSIFY_CFG = prof_classify.make_config(N).replace(force_tile=128,
                                                    use_pallas=False)


@pytest.fixture(scope="module")
def classified():
    up = prof_classify.upstream(_state(), CLASSIFY_CFG)
    counts = {s: prof_classify.classify_until(s, *up, CLASSIFY_CFG)
              for s in prof_classify.STAGES}
    return up, counts, tforces.cell_band_lists(*up, CLASSIFY_CFG)


def test_classify_stages_are_the_classifiers(classified):
    """Each stage's counts are cell_band_lists' (no cap overflows at
    these caps), and `windows` is its win_cnt bit for bit."""
    _, c, bands = classified
    assert not any(bool(getattr(bands, f"{k}_overflow"))
                   for k in ("ss", "sup", "mid", "cmid", "near"))
    pairs = {"compact0": bands.ss_cnt, "compact1": bands.sup_cnt,
             "compact2": bands.mid_cnt, "windows": bands.win_cnt}
    for stage, want in pairs.items():
        assert torch.equal(c[stage].to(torch.int32), want), stage
    want3 = torch.stack([bands.cmid_cnt, bands.near_cnt], 1)
    assert torch.equal(c["compact3"].to(torch.int32), want3)
    for s in ("0", "1", "2", "3"):
        assert torch.equal(c[f"stage{s}"], c[f"compact{s}"]), s
    assert torch.equal(c["merge"], c["windows"])
    assert bool((c["pieces"] >= c["compact3"][:, 1]).all())
    assert int(c["windows"].sum()) > 0 and int(c["compact2"].max()) > 1


def test_classify_counts_match_jax(classified):
    up, c, _ = classified
    jb = _jbands(*up, CLASSIFY_CFG)
    want = {"compact0": jb.ss_cnt, "compact1": jb.sup_cnt,
            "compact2": jb.mid_cnt, "windows": jb.win_cnt}
    for stage, w in want.items():
        np.testing.assert_array_equal(c[stage].numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        c["compact3"].numpy(), np.stack([np.asarray(jb.cmid_cnt),
                                         np.asarray(jb.near_cnt)], 1))


def test_classify_stage_times_and_config():
    r = prof_classify.stage_times(_state(), CLASSIFY_CFG,
                                  stages=("stage0", "stage3", "windows"),
                                  iters=1)
    assert list(r["ms"]) == ["stage0", "stage3", "windows"]
    assert all(v > 0 for v in r["ms"].values())
    assert 0 < r["ops"]["stage0"] < r["ops"]["stage3"] < r["ops"]["windows"]
    cfg = prof_classify.make_config(N, {"near_cap": 64})
    assert (cfg.near_cap, cfg.check_overflow, cfg.morton_bits) == (64, False,
                                                                   63)


# --- prof_winmask ------------------------------------------------------------


@pytest.mark.parametrize("win_cap", [128, 16])
def test_winmask_formulations_identical_and_match_jax(win_cap):
    """Both formulations are identical (ab raises otherwise) and equal to
    nbody_tpu's _window_masks(first, count, win_cap, 2) on the same runs;
    at win_cap 16 children drop past the cap."""
    first, count = prof_winmask.runs(256, 256)
    r = prof_winmask.ab(torch.from_numpy(first), torch.from_numpy(count),
                        win_cap, iters=1)
    assert all(v > 0 for v in r["ms"].values())
    assert "outputs identical" in prof_winmask.report(r)
    got = r["outputs"]["segmented sum (_window_masks)"]
    want = jax.jit(lambda f, c: jforces._window_masks(f, c, win_cap, 2))(
        jnp.asarray(first), jnp.asarray(count))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[4].any()) == (win_cap == 16)


def test_winmask_runs_follow_the_contract_and_k_min():
    """The runs are ascending and disjoint in every row; the JAX tool's
    layout of the same draws (run i at cumsum(lens + gaps)[i], i.e. where
    the port's run ends) overlaps in every row; k < 200 raises."""
    first, count = prof_winmask.runs(64, 200)
    drawn = first + count
    for f, d, c in zip(first, drawn, count):
        live = c > 0
        assert 60 <= live.sum() < 200
        assert (f[live][1:] > (f + c)[live][:-1]).all()
        assert (d[live][1:] < (d + c)[live][:-1]).any()
    with pytest.raises(ValueError, match="at least 200"):
        prof_winmask.runs(4, 199)
