"""nbody_tpu_torch band construction against nbody_tpu, stage by stage:
each port stage gets the JAX package's own upstream outputs, and its
integer outputs (index lists, counts, windows, lane masks, overflow
flags) must be bit-identical, its floats equal within 1e-6 relative."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import PRESETS, SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_msvc
from nbody_tpu.ops import forces as jforces
from nbody_tpu.models.simulation import sort_by_morton

from nbody_tpu_torch.convert import config_from_dict
from nbody_tpu_torch.ops import cells as tcells, forces as tforces

torch.set_num_threads(2)

GEOMETRIES = {
    # force_tile 128 with the caps of tests/test_forces.py's band tests
    "t128": (2048, dict(force_tile=128, sup_cap=64, mid_cap=512,
                        cmid_cap=1024, near_cap=1024)),
    # force_tile 128 with an odd near cap and a small window cap, so the
    # graceful window drop and the near overflow flag fire
    "t128_wincap": (2048, dict(force_tile=128, near_cap=60, win_cap=24)),
    "t256": (2048, dict(force_tile=256, sup_cap=32, mid_cap=256,
                        cmid_cap=512, near_cap=512)),
    # the shipping preset's shape (v5_bench: tile 512, no_ss) on a disk
    "t512_v5": (6000, None),
}


def _t(x):
    a = np.asarray(x)
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def _nt(tup, cls):
    return cls(*(_t(v) for v in tup))


def _key(codes):
    c = np.asarray(codes).astype(np.int64)
    return torch.from_numpy((c[:, 0] << 32) | c[:, 1])


def _configs(name):
    n, kw = GEOMETRIES[name]
    if kw is None:
        jc = PRESETS["v5_bench"].replace(n=n, use_pallas=False,
                                         check_overflow=False)
    else:
        jc = JConfig(n=n, theta=0.5, use_pallas=False, check_overflow=False,
                     **kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def ref(request):
    """The JAX package's band structures for one geometry."""
    jc, tc = _configs(request.param)
    if jc.ic_kind == "disk_galaxy" and jc.n == 6000:
        st = disk_galaxy_msvc(jc.n)
        pos, mass = st.pos, st.mass
    else:
        rng = np.random.default_rng(4)
        pos = jnp.asarray(rng.uniform(-1000, 1000, (jc.n, 3)).astype(np.float32))
        mass = jnp.asarray(rng.uniform(1.0, 5.0, jc.n).astype(np.float32))
    sc, perm, _, _ = sort_by_morton(pos, jc)
    ps, ms, cs = jforces.pad_sorted(pos[perm], mass[perm], sc, jc.force_tile)
    cells, ss, bands, tables = jax.jit(
        lambda p, m, c: jforces.build_bands(p, m, c, jc))(ps, ms, cs)
    supers = jforces.make_supers(cells)
    tgt = jforces.target_subspheres(ps, jc.force_tile, codes=cs)
    return dict(name=request.param, jc=jc, tc=tc, ps=ps, ms=ms, cs=cs,
                cells=cells, supers=supers, ss=ss, bands=bands,
                tables=tables, tgt=tgt)


def _close(got, want, name, scale=1.0):
    """Within 1e-6 relative, of the value or of the coordinate `scale`
    (a centre of mass near the origin cancels to a few ulps of it)."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * scale, err_msg=name)


def _scale(ref):
    return float(np.abs(np.asarray(ref["ps"])).max())


def test_target_subspheres_match(ref):
    b = ref["jc"].force_tile
    got = tforces.target_subspheres(_t(ref["ps"]), b, codes=_key(ref["cs"]),
                                    bits=63)
    for name in tforces.GroupInfo._fields:
        _close(getattr(got, name), getattr(ref["tgt"], name), name,
               _scale(ref))
    # with per-particle drift, and without codes (fixed strides)
    drift = np.random.default_rng(1).uniform(0, 3, ref["ps"].shape[0]).astype(
        np.float32)
    want = jforces.target_subspheres(ref["ps"], b, drift=jnp.asarray(drift),
                                     codes=ref["cs"])
    got = tforces.target_subspheres(_t(ref["ps"]), b,
                                    drift=torch.from_numpy(drift),
                                    codes=_key(ref["cs"]), bits=63)
    _close(got.skin, want.skin, "skin")
    want = jforces.target_subspheres(ref["ps"], b)
    got = tforces.target_subspheres(_t(ref["ps"]), b)
    _close(got.radius, want.radius, "radius (strided)")


def test_supers_and_ss_match(ref):
    cells = _nt(ref["cells"], tcells.SourceCells)
    supers = tforces.make_supers(cells)
    ss = tforces.make_ss(tforces.make_supers(cells), ref["tc"])
    for got, want in ((supers, ref["supers"]), (ss, ref["ss"])):
        assert int(got.n_supers) == int(want.n_supers)
        for name in tforces.Supers._fields[:-1]:
            _close(getattr(got, name), getattr(want, name), name, _scale(ref))


def test_no_ss_requires_ss_cap_at_least_n_ss(ref):
    cells = _nt(ref["cells"], tcells.SourceCells)
    n_ss = ref["ss"].com.shape[0]
    cfg = ref["tc"].replace(no_ss=True, ss_cap=n_ss - 1)
    with pytest.raises(ValueError, match="ss_cap"):
        tforces.make_ss(tforces.make_supers(cells), cfg)


def test_cell_band_lists_match(ref):
    got = tforces.cell_band_lists(
        _nt(ref["tgt"], tforces.GroupInfo), _nt(ref["ss"], tforces.Supers),
        _nt(ref["supers"], tforces.Supers),
        _nt(ref["cells"], tcells.SourceCells), ref["tc"])
    want = ref["bands"]
    assert int(got.near_cnt.sum()) > 0 and int(got.win_cnt.sum()) > 0
    for name in tforces.CellBands._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if ref["name"] == "t128_wincap":
        assert bool(got.near_overflow)


def test_build_cell_tables_match(ref):
    got = tforces.build_cell_tables_torch(
        _nt(ref["cells"], tcells.SourceCells),
        _nt(ref["supers"], tforces.Supers), _nt(ref["ss"], tforces.Supers),
        _nt(ref["bands"], tforces.CellBands))
    # the JAX tables come from the jitted build, whose fused aggregation
    # may round the super-level moments differently from make_supers
    for name in tforces.TableSet._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(ref["tables"],
                                                              name))
        assert g.shape == w.shape, name
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w, name, _scale(ref))


def test_window_masks_match_both_jax_variants(ref):
    """The port's one window routine against the JAX production version
    and its dense oracle, at a window cap that drops children (the
    production cap is covered by test_cell_band_lists_match)."""
    bands, cells = ref["bands"], ref["cells"]
    jc = ref["jc"]
    k_cap = 8 * cells.gmass.shape[0]
    fc = np.concatenate([
        np.stack([np.asarray(cells.child_first).reshape(-1),
                  np.asarray(cells.child_count).reshape(-1)], 1),
        np.zeros((1, 2), np.int32)])
    runs = fc[np.minimum(np.asarray(bands.near_idx), k_cap)]
    first, count = runs[..., 0], runs[..., 1]
    win_cap = 5
    args = (jnp.asarray(first), jnp.asarray(count))
    w_prod = jax.jit(lambda f, c: jforces._window_masks(
        f, c, win_cap, pieces=jc.win_pieces))(*args)
    w_dense = jax.jit(lambda f, c: jforces._window_masks_dense(
        f, c, win_cap, pieces=jc.win_pieces))(*args)
    got = tforces._window_masks(torch.from_numpy(first.astype(np.int64)),
                                torch.from_numpy(count.astype(np.int64)),
                                win_cap, jc.win_pieces)
    for g, wp, wd in zip(got, w_prod, w_dense):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wd))


def test_lowmask_wraps_like_int32_jnp():
    k = np.arange(-3, 41, dtype=np.int32)
    np.testing.assert_array_equal(
        tforces._lowmask(torch.from_numpy(k.astype(np.int64))).numpy(),
        np.asarray(jforces._lowmask(jnp.asarray(k))))
    assert int(tforces._lowmask(torch.tensor([31]))[0]) == 0x7FFFFFFF
    assert int(tforces._lowmask(torch.tensor([32]))[0]) == -1


def test_row_compaction_matches():
    rng = np.random.default_rng(7)
    big = tforces._BIG
    key = np.where(rng.random((16, 40)) < 0.3, rng.integers(0, 500, (16, 40)),
                   big).astype(np.int32)
    for cap in (8, 40, 64):
        wi, wc = jforces._row_compact_one(jnp.asarray(key), big, cap)
        ti, tc = tforces._row_compact_one(torch.from_numpy(
            key.astype(np.int64)), big, cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(wc))
