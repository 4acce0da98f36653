"""The plain PyTorch versions of the three force kernels against the JAX
package's jnp twins and its Pallas kernels (interpret mode on the CPU,
as tests/test_forces.py runs them), on the JAX package's own band
structures; the kernel wrappers' CPU dispatch."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import PRESETS, SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_msvc
from nbody_tpu.models.simulation import sort_by_morton
from nbody_tpu.ops import forces as jforces
from nbody_tpu.ops.pallas.forces import (far_sweep_pallas, near_span_pallas,
                                         table_sweep_pallas)

from nbody_tpu_torch.convert import config_from_dict
from nbody_tpu_torch.ops import forces as tforces
from nbody_tpu_torch.ops.cuda import forces as kern

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-4)


def _t(x):
    a = np.asarray(x)
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def _build(jc, pos, mass):
    sc, perm, _, _ = sort_by_morton(pos, jc)
    ps, ms, cs = jforces.pad_sorted(pos[perm], mass[perm], sc, jc.force_tile)
    cells, ss, bands, tables = jax.jit(
        lambda p, m, c: jforces.build_bands(p, m, c, jc))(ps, ms, cs)
    tc = config_from_dict(dataclasses.asdict(jc))
    port = dict(ps=_t(ps), ms=_t(ms),
                ss=tforces.Supers(*(_t(x) for x in ss)),
                tables=tforces.TableSet(*(_t(x) for x in tables)),
                bands=tforces.CellBands(
                    *(torch.from_numpy(np.array(x)) for x in bands)))
    return dict(jc=jc, tc=tc, ps=ps, ms=ms, ss=ss, bands=bands,
                tables=tables, port=port)


@pytest.fixture(scope="module")
def small():
    """n=1024 at force_tile 128: the geometry of tests/test_forces.py's
    Pallas-vs-jnp test."""
    rng = np.random.default_rng(6)
    pos = jnp.asarray(rng.uniform(-1000, 1000, (1024, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(1.0, 5.0, 1024).astype(np.float32))
    jc = JConfig(n=1024, theta=0.5, force_tile=128, use_pallas=False,
                 sup_cap=64, mid_cap=512, cmid_cap=1024, near_cap=1024)
    return _build(jc, pos, mass)


@pytest.fixture(scope="module")
def v5():
    """The shipping preset's shape on a 6000-body disk galaxy."""
    jc = PRESETS["v5_bench"].replace(n=6000, use_pallas=False,
                                     check_overflow=False)
    st = disk_galaxy_msvc(6000)
    return _build(jc, st.pos, st.mass)


def _plain(r, which):
    p, tc = r["port"], r["tc"]
    if which == "far":
        return tforces.far_sweep_torch(p["ps"], p["ss"], tc)
    if which == "table":
        return tforces.table_sweep_torch(p["ps"], p["tables"], tc)
    b = p["bands"]
    return tforces.near_correction_torch(p["ps"], p["ps"], p["ms"],
                                         b.win_first, b.win_mask, b.win_cnt, tc)


def _jnp(r, which):
    jc = r["jc"]
    if which == "far":
        return jforces.far_sweep_jnp(r["ps"], r["ss"], jc)
    if which == "table":
        return jforces.table_sweep_jnp(r["ps"], r["tables"], jc)
    b = r["bands"]
    return jforces.near_correction_jnp(r["ps"], r["ps"], r["ms"], b.win_first,
                                       b.win_mask, jc)


@pytest.mark.parametrize("which", ["far", "table", "near"])
def test_plain_versions_match_jnp_twins(small, v5, which):
    for r in (small, v5):
        got = _plain(r, which).numpy()
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, np.asarray(_jnp(r, which)), **TOL)


@pytest.mark.parametrize("which", ["far", "table", "near"])
def test_plain_versions_match_pallas_interpret(small, which):
    jc = small["jc"]
    b = small["bands"]
    if which == "far":
        want = far_sweep_pallas(small["ps"], small["ss"], jc)
    elif which == "table":
        want = table_sweep_pallas(small["ps"], small["tables"], jc)
    else:
        want = near_span_pallas(small["ps"], small["ps"], small["ms"],
                                b.win_first, b.win_mask, b.win_cnt, jc)
    np.testing.assert_allclose(_plain(small, which).numpy(), np.asarray(want),
                               **TOL)


def test_near_iterates_win_cnt_like_the_pallas_kernel(small):
    """Windows at or past win_cnt are not swept, whatever their masks hold
    (the Pallas kernel's contract; the jnp twin counts mask-live windows
    instead)."""
    p = small["port"]
    b = p["bands"]
    cnt = torch.clamp(b.win_cnt - 1, min=0)
    got = tforces.near_correction_torch(p["ps"], p["ps"], p["ms"], b.win_first,
                                        b.win_mask, cnt, small["tc"])
    jb = small["bands"]
    want = near_span_pallas(small["ps"], small["ps"], small["ms"],
                            jb.win_first, jb.win_mask,
                            jnp.asarray(cnt.numpy(), jnp.int32), small["jc"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = _plain(small, "near")
    assert float((got - full).abs().max()) > 0


def test_wrappers_on_cpu_take_the_plain_versions(v5):
    p, tc = v5["port"], v5["tc"]
    before = dict(kern.LAUNCHES)
    b = p["bands"]
    pairs = [
        (kern.far_sweep(p["ps"], p["ss"], tc), _plain(v5, "far")),
        (kern.table_sweep(p["ps"], p["tables"], tc), _plain(v5, "table")),
        (kern.near_span(p["ps"], p["ps"], p["ms"], b.win_first, b.win_mask,
                        b.win_cnt, tc), _plain(v5, "near")),
    ]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kern.LAUNCHES == before          # no kernel launched on the CPU
    for use in (True, False):
        cfg = tc.replace(use_pallas=use)
        got = tforces.apply_bands(p["ps"], p["ms"], p["ss"], b, p["tables"], cfg)
        want = jforces.apply_bands(v5["ps"], v5["ms"], v5["ss"], v5["bands"],
                                   v5["tables"], v5["jc"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_reject_tensors_off_cpu_and_cuda(small):
    p, tc = small["port"], small["tc"]
    meta = torch.empty(p["ps"].shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kern.far_sweep(meta, p["ss"], tc)
    with pytest.raises(ValueError, match="CUDA"):
        kern.table_sweep(meta, p["tables"], tc)
