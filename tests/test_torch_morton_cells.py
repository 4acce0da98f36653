"""nbody_tpu_torch Morton codes, sort and adaptive cells against
nbody_tpu on the same inputs: integer outputs bit-identical, moments
within float32 prefix-sum tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.ops import bbox as jbbox, cells as jcells, forces as jforces
from nbody_tpu.ops import morton as jmorton
from nbody_tpu.models.simulation import sort_by_morton as jsort_by_morton

from nbody_tpu_torch.config import SimConfig as TConfig
from nbody_tpu_torch.ops import cells as tcells, morton as tmorton
from nbody_tpu_torch.models.simulation import sort_by_morton as tsort_by_morton

torch.set_num_threads(2)


def _clouds():
    rng = np.random.default_rng(21)
    uni = rng.uniform(-1000, 1000, (3000, 3)).astype(np.float32)
    c = rng.uniform(-400, 400, (5, 3))
    clus = (c[rng.integers(0, 5, 3000)]
            + rng.normal(0, 2.0, (3000, 3))).astype(np.float32)
    # exact duplicates and points on the max faces
    dup = np.concatenate([uni[:1000], uni[:500], np.full((20, 3), 1000.0,
                                                         np.float32)])
    return {"uniform": uni, "clustered": clus, "duplicates": dup}


CLOUDS = _clouds()


def key63(codes):
    """JAX (hi, lo) uint32 pairs [N, 2] -> int64 keys."""
    c = np.asarray(codes).astype(np.int64)
    return (c[:, 0] << 32) | c[:, 1]


def _t(x):
    a = np.asarray(x)
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


# --- (d) Morton keys and permutation ----------------------------------------


def test_expand_bits_exhaustive():
    v = np.arange(2048, dtype=np.uint32)
    np.testing.assert_array_equal(
        tmorton.expand_bits(torch.from_numpy(v.astype(np.int64))).numpy(),
        np.asarray(jmorton.expand_bits(jnp.asarray(v))).astype(np.int64))


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_encode_and_sort_match(cloud):
    pos = CLOUDS[cloud]
    lo, size = jbbox.bounding_cube(jnp.asarray(pos))
    lo_t, size_t = _t(lo), torch.tensor(float(size))
    p = torch.from_numpy(pos)
    # 30-bit
    c30 = np.asarray(jmorton.encode30(jnp.asarray(pos), lo, size))
    t30 = tmorton.encode30(p, lo_t, size_t)
    np.testing.assert_array_equal(t30.numpy(), c30.astype(np.int64))
    _, jperm30 = jmorton.morton_sort_30(jnp.asarray(c30))
    np.testing.assert_array_equal(tmorton.morton_sort(t30)[1].numpy(),
                                  np.asarray(jperm30))
    # 63-bit: one int64 key == (hi << 32) | lo
    hi, lo32 = jmorton.encode63(jnp.asarray(pos), lo, size)
    t63 = tmorton.encode63(p, lo_t, size_t)
    np.testing.assert_array_equal(
        t63.numpy(), key63(np.stack([np.asarray(hi), np.asarray(lo32)], 1)))
    _, _, jperm63 = jmorton.morton_sort_63(hi, lo32)
    np.testing.assert_array_equal(tmorton.morton_sort(t63)[1].numpy(),
                                  np.asarray(jperm63))


@pytest.mark.parametrize("bits", [30, 63])
def test_sort_by_morton_matches(bits):
    pos = CLOUDS["clustered"]
    cs, perm, lo, size = jsort_by_morton(jnp.asarray(pos),
                                         JConfig(n=3000, morton_bits=bits))
    ts, tperm, tlo, tsize = tsort_by_morton(torch.from_numpy(pos),
                                            TConfig(n=3000, morton_bits=bits))
    want = key63(cs) if bits == 63 else np.asarray(cs).astype(np.int64)
    np.testing.assert_array_equal(ts.numpy(), want)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))


def test_bit_length_exact_near_float_rounding():
    vals = [0, 1, 2, 3, 7, 8, (1 << 53) - 1, 1 << 53, (1 << 53) + 1,
            (1 << 62) - 1, 1 << 62, (1 << 63) - 1]
    rng = np.random.default_rng(0)
    vals += [int(v) for v in rng.integers(0, 1 << 62, 200)]
    got = tcells.bit_length(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [v.bit_length() for v in vals]


@pytest.mark.parametrize("bits", [30, 63])
def test_lcp_and_cell_corner_match(bits):
    pos = CLOUDS["clustered"]
    cfg = JConfig(n=3000, morton_bits=bits)
    cs, _, lo, size = jsort_by_morton(jnp.asarray(pos), cfg)
    ts = torch.from_numpy(key63(cs) if bits == 63
                          else np.asarray(cs).astype(np.int64))
    np.testing.assert_array_equal(
        tcells.adjacent_lcp(ts, bits).numpy(),
        np.asarray(jcells.adjacent_lcp(cs)).astype(np.int64))
    rng = np.random.default_rng(1)
    depth = rng.integers(0, tcells.max_depth_of(bits) + 3, cs.shape[0])
    want = jcells.cell_corner(cs, jnp.asarray(depth, jnp.int32), lo, size)
    got = tcells.cell_corner(ts, torch.from_numpy(depth), _t(lo),
                             torch.tensor(float(size)), bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-3)


# --- (e) adaptive cells ------------------------------------------------------

_INT_FIELDS = ("first", "count", "child_first", "child_count",
               "gchild_complete", "n_cells", "n_child", "n_g2", "overflow",
               "overflow_g2")


@pytest.mark.parametrize("bits,tile,analytic,drift,g2", [
    (63, 512, True, False, 4),
    (63, 128, True, True, 4),
    (30, 256, True, False, 8),
    (63, 256, False, True, 1),     # bbox geometry, forced g2 overflow
])
def test_build_source_cells_matches(bits, tile, analytic, drift, g2):
    pos = CLOUDS["clustered"]
    mass = np.random.default_rng(2).uniform(1, 5, pos.shape[0]).astype(
        np.float32)
    cfg = JConfig(n=pos.shape[0], morton_bits=bits, force_tile=tile,
                  use_pallas=False)
    cs, perm, lo, size = jsort_by_morton(jnp.asarray(pos), cfg)
    ps, ms, csp = jforces.pad_sorted(jnp.asarray(pos)[perm],
                                     jnp.asarray(mass)[perm], cs, tile)
    dr = (np.random.default_rng(3).uniform(0, 5, ps.shape[0]).astype(np.float32)
          if drift else None)
    box = (jbbox.bounding_cube(ps) if analytic else (None, None))
    # a tight cell capacity puts the grandchild cap below demand at g2=1
    cap = 64 if g2 == 1 else cfg.cell_capacity
    want = jax.jit(lambda c, p, m, d, bl, bs: jcells.build_source_cells(
        c, p, m, tile, cfg.g, cap, bl, bs, drift_sorted=d, g2_factor=g2))(
        csp, ps, ms, None if dr is None else jnp.asarray(dr), *box)
    codes_t = torch.from_numpy(key63(csp) if bits == 63
                               else np.asarray(csp).astype(np.int64))
    got = tcells.build_source_cells(
        codes_t, _t(ps), _t(ms), tile, cfg.g, cap,
        *(None if b is None else _t(b) for b in box),
        drift_sorted=None if dr is None else torch.from_numpy(dr),
        g2_factor=g2, bits=bits)
    assert int(got.n_cells) > 8
    if g2 == 1:
        assert bool(got.overflow_g2)
    # moments come from prefix sums, float32 in the JAX package (another
    # summation order; the port's are float64): bound their difference by
    # the float32 rounding of the whole prefix, mass-scaled
    eps = 16 * np.finfo(np.float32).eps
    m_tol = eps * cfg.g * float(np.sum(mass))
    mx_tol = eps * cfg.g * float(np.sum(mass[:, None] * np.abs(pos)))
    moments = {"com": "gmass", "child_com": "child_gmass",
               "gchild_com": "gchild_gmass"}
    for name in tcells.SourceCells._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in _INT_FIELDS:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
        elif name in moments.values():
            np.testing.assert_allclose(g, w, rtol=0, atol=m_tol, err_msg=name)
        elif name in moments:
            gm_g = getattr(got, moments[name]).numpy()[..., None]
            gm_w = np.asarray(getattr(want, moments[name]))[..., None]
            np.testing.assert_allclose(g * gm_g, w * gm_w, rtol=0,
                                       atol=mx_tol, err_msg=name)
        else:
            # geometry: corner + width arithmetic may round differently
            # (fused multiply-add), so at most a few ulps of the box scale
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(pos).max()),
                                       err_msg=name)
