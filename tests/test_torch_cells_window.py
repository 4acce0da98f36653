"""nbody_tpu_torch's owner-computes cell build (the multi-device path's
per-shard cut) against the port's global build and against nbody_tpu's
windowed build on the same windows: integer fields bit-identical,
moments within float32 prefix-sum tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.ops import bbox as jbbox, cells as jcells, morton as jmorton

from nbody_tpu_torch.ops import cells as tcells

torch.set_num_threads(2)

# the cases of tests/test_cells.py's test_windowed_build_stitches_to_global
CASES = [
    (63, 4096, 64, 4, False),
    (63, 4096, 64, 8, True),      # clustered: exercises at_max b-runs
    (30, 2048, 32, 4, True),      # 30-bit floor saturates fast
    (63, 4096 + 192, 64, 4, False),  # n not a multiple of d*b pre-pad
]
INT_FIELDS = ("first", "count", "child_first", "child_count",
              "gchild_complete")
GEOM_FIELDS = ("diam", "lo", "hi", "child_diam", "gchild_diam_max", "skin",
               "child_skin")


def _inputs(bits, n, b, d, clustered):
    """tests/test_cells.py's sorted, d*b-padded arrays: (JAX arrays, the
    same as torch tensors with int64 keys, box lo, box size)."""
    rng = np.random.default_rng(bits + n + d)
    if clustered:
        c = rng.uniform(-500, 500, (3, 3))
        pos = (c[rng.integers(0, 3, n)]
               + rng.normal(0, 1e-4, (n, 3))).astype(np.float32)
    else:
        pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 5, n).astype(np.float32)
    lo, size = jbbox.bounding_cube(jnp.asarray(pos))
    if bits == 63:
        hi_, lo32 = jmorton.encode63(jnp.asarray(pos), lo, size)
        shi, slo, perm = jmorton.morton_sort_63(hi_, lo32)
        sc = jnp.stack([shi, slo], axis=1)
    else:
        codes = jmorton.encode30(jnp.asarray(pos), lo, size)
        sc, perm = jmorton.morton_sort_30(codes)
    ps, ms = jnp.asarray(pos)[perm], jnp.asarray(mass)[perm]
    drift = jnp.asarray(rng.uniform(0, 2, n).astype(np.float32))[perm]
    n_pad = -(-n // (d * b)) * (d * b)
    pad = n_pad - n
    if pad:
        sc = jnp.concatenate([sc, jnp.broadcast_to(sc[-1],
                                                   (pad,) + sc.shape[1:])])
        ps = jnp.concatenate([ps, jnp.broadcast_to(ps[-1], (pad, 3))])
        ms = jnp.concatenate([ms, jnp.zeros((pad,), ms.dtype)])
        drift = jnp.concatenate([drift, jnp.zeros((pad,), drift.dtype)])
    c = np.asarray(sc).astype(np.int64)
    key = (c[:, 0] << 32) | c[:, 1] if c.ndim == 2 else c
    tor = tuple(torch.from_numpy(np.array(x)) for x in
                (key, np.asarray(ps), np.asarray(ms), np.asarray(drift),
                 np.asarray(lo), np.asarray(size)))
    return (sc, ps, ms, drift, lo, size), tor


def _carries(lasts):
    """Exclusive prefix max of the shards' last boundaries."""
    out, run = [], -1
    for last in lasts:
        out.append(run)
        run = max(run, last)
    return out


def _port_shards(tor, b, d, gs, bits):
    key, ps, ms, dr, lo, size = tor
    n_pad = key.shape[0]
    m, halo = n_pad // d, 4 * b
    edge = torch.clamp(torch.arange(-halo, n_pad + halo), 0, n_pad - 1)
    lasts = [int(tcells.last_bmax_boundary(
        key[st:st + m], key[st - 1] if st else key[0], st, bits))
        for st in range(0, n_pad, m)]
    shards = []
    for sh, carry in enumerate(_carries(lasts)):
        win = edge[sh * m: sh * m + m + 2 * halo]
        shards.append(tcells.build_source_cells_window(
            key[win], ps[win], ms[win], b, 0.5, gs, sh * m, m, n_pad,
            carry, lo, size, drift_sorted=dr[win], g2_factor=4, bits=bits))
    return lasts, shards


def _jax_shards(jx, b, d, gs):
    sc, ps, ms, drift, lo, size = jx
    n_pad = ps.shape[0]
    m, halo = n_pad // d, 4 * b

    def edge_pad(x):
        left = jnp.broadcast_to(x[:1], (halo,) + x.shape[1:])
        right = jnp.broadcast_to(x[-1:], (halo,) + x.shape[1:])
        return jnp.concatenate([left, x, right])

    scp, psp, msp, dfp = (edge_pad(x) for x in (sc, ps, ms, drift))
    lasts = [int(jcells.last_bmax_boundary(
        sc[st:st + m], sc[st - 1] if st else sc[0], st))
        for st in range(0, n_pad, m)]
    # one compilation serves every shard (start and carry are traced)
    build = jax.jit(jcells.build_source_cells_window, static_argnames=(
        "b", "g_const", "g_cap_shard", "own", "n_total", "g2_factor"))
    shards = []
    for sh, carry in enumerate(_carries(lasts)):
        win = slice(sh * m, sh * m + m + 2 * halo)
        shards.append(build(
            scp[win], psp[win], msp[win], b=b, g_const=0.5, g_cap_shard=gs,
            start=jnp.int32(sh * m), own=m, n_total=n_pad,
            bmax_carry=jnp.int32(carry), box_lo=lo, box_size=size,
            drift_sorted=dfp[win], g2_factor=4))
    return lasts, shards


def _np(x):
    a = np.asarray(x)
    return a.astype(np.int64) if a.dtype in (np.int32, np.uint32) else a


def _assert_moments_close(got, want, gm, noise):
    """tests/test_cells.py's moment bounds: gmass within 1e-3; a COM
    within 1e-2 plus the float32 prefix's cancellation noise over the
    segment's mass, where the segment carries real mass."""
    for f, mf in (("com", "gmass"), ("child_com", "child_gmass"),
                  ("gchild_com", "gchild_gmass")):
        np.testing.assert_allclose(got[mf], want[mf], rtol=1e-3, atol=1e-3,
                                   err_msg=mf)
        allow = 1e-2 + noise / np.maximum(gm[mf], 1e-6)
        err = np.abs(got[f] - want[f]).max(axis=-1)
        err = np.where(gm[mf] > 1e-2, err, 0.0)
        assert np.all(err <= allow), f"{f}: max excess {(err - allow).max()}"


@pytest.mark.parametrize("bits,n,b,d,clustered", CASES)
def test_windowed_build_stitches_to_global(bits, n, b, d, clustered):
    """The port's shards concatenated in shard order are the port's
    global build_source_cells."""
    _, tor = _inputs(bits, n, b, d, clustered)
    key, ps, ms, dr, lo, size = tor
    n_pad = key.shape[0]
    g_cap = max(64, 8 * n_pad // b)
    want = tcells.build_source_cells(key, ps, ms, b, 0.5, g_cap, lo, size,
                                     drift_sorted=dr, g2_factor=4, bits=bits)
    _, shards = _port_shards(tor, b, d, g_cap, bits)

    counts = [int(s.n_cells) for s in shards]
    gn = int(want.n_cells)
    assert sum(counts) == gn
    assert sum(int(s.n_child) for s in shards) == int(want.n_child)
    assert sum(int(s.n_g2) for s in shards) == int(want.n_g2)

    def stitched(field):
        return np.concatenate([_np(getattr(s, field))[:c]
                               for s, c in zip(shards, counts)])

    for f in INT_FIELDS:
        np.testing.assert_array_equal(stitched(f),
                                      _np(getattr(want, f))[:gn], err_msg=f)
    for f in GEOM_FIELDS:
        np.testing.assert_allclose(stitched(f), _np(getattr(want, f))[:gn],
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    fields = ("com", "gmass", "child_com", "child_gmass", "gchild_com",
              "gchild_gmass")
    got = {f: stitched(f) for f in fields}
    ref = {f: _np(getattr(want, f))[:gn] for f in fields}
    noise = 4 * 1.2e-7 * float((0.5 * ms * ps.abs().amax(dim=1)).sum())
    _assert_moments_close(got, ref, ref, noise)
    assert not any(bool(s.overflow) for s in shards)


@pytest.mark.parametrize("bits,n,b,d,clustered", CASES)
def test_windowed_build_matches_jax(bits, n, b, d, clustered):
    """Shard by shard on the same windows: last_bmax_boundary and every
    integer field (over the whole capacity) equal to nbody_tpu's
    build_source_cells_window; geometry to float32 rounding; moments
    within the float32 prefix's tolerance."""
    jx, tor = _inputs(bits, n, b, d, clustered)
    n_pad = tor[0].shape[0]
    gs = max(64, 8 * n_pad // b) // d + 64
    j_lasts, jsh = _jax_shards(jx, b, d, gs)
    t_lasts, tsh = _port_shards(tor, b, d, gs, bits)
    assert t_lasts == j_lasts
    _, ps, ms, _, lo, size = tor
    noise = 4 * 1.2e-7 * float((0.5 * ms * ps.abs().amax(dim=1)).sum())
    # corners and widths sum float32 terms at the box's scale, which XLA
    # may contract into FMAs: a few ulps of the box coordinates
    geom_atol = 4 * float(np.spacing(np.float32(lo.abs().max() + size)))
    for sh, (w, g) in enumerate(zip(jsh, tsh)):
        for f in INT_FIELDS + ("n_cells", "n_child", "n_g2", "overflow",
                               "overflow_g2"):
            np.testing.assert_array_equal(_np(getattr(g, f)),
                                          _np(getattr(w, f)),
                                          err_msg=f"shard {sh} {f}")
        for f in GEOM_FIELDS:
            np.testing.assert_allclose(_np(getattr(g, f)), _np(getattr(w, f)),
                                       rtol=1e-6, atol=geom_atol,
                                       err_msg=f"shard {sh} {f}")
        fields = ("com", "gmass", "child_com", "child_gmass", "gchild_com",
                  "gchild_gmass")
        got = {f: _np(getattr(g, f)) for f in fields}
        ref = {f: _np(getattr(w, f)) for f in fields}
        _assert_moments_close(got, ref, ref, noise)
