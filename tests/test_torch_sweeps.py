"""The plain PyTorch versions of the three force kernels against the JAX
package's jnp twins and its Pallas kernels (interpret mode on the CPU,
as tests/test_forces.py runs them), on the JAX package's own band
structures; the kernel wrappers' CPU dispatch."""

import dataclasses
from pathlib import Path

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


# --- the far sweep at the counts its kernel must serve ----------------------

# (targets, super-super rows S, live count, massless rows ending the live
# prefix): n off any tile size, no / one / seven live rows, every row
# live, a live count past S (the kernel clamps it), massless pads
FAR_EDGES = [
    (3001, 192, 105, 0),
    (1024, 192, 0, 0),
    (1024, 192, 1, 0),
    (1024, 192, 7, 0),
    (1024, 192, 192, 0),
    (1024, 192, 250, 0),
    (1024, 192, 120, 16),
    (3001, 64, 64, 8),
]


def _far_edge_inputs(n, s, live, pads, seed):
    """numpy targets and super-super rows: a thin disk of radius 1700,
    positive masses on the live rows but their last `pads`, rows past the
    live count massless at the origin (as the band build pads them)."""
    rng = np.random.default_rng(seed)

    def disk(m):
        x = rng.uniform(-1700, 1700, (m, 3)).astype(np.float32)
        x[:, 2] *= np.float32(0.05)
        return x

    pos, com = disk(n), disk(s)
    gmass = rng.uniform(1.0, 1e4, s).astype(np.float32)
    k = min(live, s)
    gmass[k - pads:k] = 0
    gmass[k:] = 0
    com[k:] = 0
    return pos, com, gmass


@pytest.mark.parametrize("n,s,live,pads", FAR_EDGES)
def test_far_plain_matches_jax_at_edge_counts(n, s, live, pads):
    """far_sweep_torch against far_sweep_jnp (its targets padded to whole
    tiles of 64, which leaves the real targets' sums alone) and, where n is
    whole tiles of 128, against far_sweep_pallas in interpret mode, which
    reads the live count; the kernel wrapper on the CPU returns the plain
    version and launches nothing."""
    pos, com, gmass = _far_edge_inputs(n, s, live, pads, seed=n + s + live)
    jc = JConfig(n=n, force_tile=128 if n % 128 == 0 else 64,
                 use_pallas=n % 128 == 0,
                 softening=PRESETS["v5_bench"].softening)
    tc = config_from_dict(dataclasses.asdict(jc))
    zero = np.zeros(s, np.float32)
    jss = jforces.Supers(com=jnp.asarray(com), gmass=jnp.asarray(gmass),
                         diam=jnp.asarray(zero), lo=jnp.asarray(com),
                         hi=jnp.asarray(com), skin=jnp.asarray(zero),
                         n_supers=jnp.asarray(live, jnp.int32))
    tss = tforces.Supers(com=torch.from_numpy(com),
                         gmass=torch.from_numpy(gmass),
                         diam=torch.from_numpy(zero),
                         lo=torch.from_numpy(com), hi=torch.from_numpy(com),
                         skin=torch.from_numpy(zero),
                         n_supers=torch.tensor(live, dtype=torch.int64))
    tpos = torch.from_numpy(pos)
    got = tforces.far_sweep_torch(tpos, tss, tc).numpy()
    assert got.shape == (n, 3)
    if live > 0:
        assert np.abs(got).max() > 0
    else:
        assert not got.any()
    pad = -n % jc.force_tile
    jpos = jnp.asarray(np.concatenate([pos, np.zeros((pad, 3), np.float32)]))
    np.testing.assert_allclose(got, np.asarray(
        jforces.far_sweep_jnp(jpos, jss, jc))[:n], **TOL)
    if n % 128 == 0:
        np.testing.assert_allclose(got, np.asarray(
            far_sweep_pallas(jnp.asarray(pos), jss, jc)), **TOL)
    before = dict(kern.LAUNCHES)
    torch.testing.assert_close(kern.far_sweep(tpos, tss, tc),
                               torch.from_numpy(got), rtol=0, atol=0)
    assert kern.LAUNCHES == before


@pytest.mark.parametrize("n", [1, 3001, 20_000, 50_001, 50_176, 100_000,
                               500_224, 1_000_448, 4_001_792])
def test_far_geometry_covers_every_target_once(n):
    """The far sweep's grid holds every target once: its last block is
    the only one with masked lanes."""
    blocks = kern.far_blocks(n)
    per_block = kern.FAR_TARGETS * kern.FAR_THREADS
    assert (blocks - 1) * per_block < n <= blocks * per_block


def test_far_geometry_fills_the_last_round():
    """Every block of the far sweep does the same work: at n = 100,000
    (the ensemble's bh_100k) on 132 SMs the last of the rounds of one
    block per SM is at least half full (127 of 132)."""
    sms = 132
    blocks = kern.far_blocks(100_000)
    last = blocks - (-(-blocks // sms) - 1) * sms
    assert (blocks, last) == (391, 127) and last >= sms / 2


def test_far_block_is_the_kernels():
    src = (Path(tforces.__file__).parents[1] / "csrc" /
           "tile_sweeps.cu").read_text()
    assert f"constexpr int kThreads = {kern.FAR_THREADS};" in src
    assert f"constexpr int kFarTargets = {kern.FAR_TARGETS};" in src
