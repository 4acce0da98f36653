"""Adaptive octree source cells from sorted Morton codes.

Port of nbody_tpu/ops/cells.py (see there for the derivation): for every
particle the shallowest depth whose Morton cell holds <= B particles,
computed from two sliding-window extrema over the adjacent-LCP array;
cells, their depth+1 children and depth+2 grandchildren are contiguous
runs of the sorted order, compacted to static capacities, with monopoles
from prefix sums and analytic (lattice) geometry.

Differences from the JAX build, none of which changes an integer output:

  * codes are int64 keys of `bits` = 30 or 63 significant bits, so the
    leading-zero count becomes an exact integer bit length (a 6-step
    binary search on shifts; a float log2 would round keys above 2^53);
  * segmented scans become segment ids (cumsum of the boundary flags)
    with ``scatter_reduce``;
  * the mass and mass-moment prefix sums run in float64 and the moments
    are rounded to float32 once, so they agree with the JAX float32
    prefix only to its rounding (summation order differs anyway).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

MAX_DEPTH = 10     # 30-bit codes / 3 bits per level
MAX_DEPTH_63 = 21  # 63-bit codes
_BIG_F = 3.0e38
_I64 = torch.int64


class SourceCells(NamedTuple):
    """Adaptive cut cells padded to a static capacity g_cap (field
    meanings as in nbody_tpu.ops.cells.SourceCells)."""

    first: torch.Tensor        # [Gc] int64 sorted-particle start (0 pad)
    count: torch.Tensor        # [Gc] int64 particles in cell (0 pad)
    com: torch.Tensor          # [Gc, 3]
    gmass: torch.Tensor        # [Gc] G * mass (0 pad)
    diam: torch.Tensor         # [Gc] cell width (0 pad)
    lo: torch.Tensor           # [Gc, 3] lower corner (+3e38 pad)
    hi: torch.Tensor           # [Gc, 3] upper corner (-3e38 pad)
    child_com: torch.Tensor    # [Gc, 8, 3]
    child_gmass: torch.Tensor  # [Gc, 8]
    child_diam: torch.Tensor   # [Gc, 8]
    child_diam_max: torch.Tensor  # [Gc]
    child_first: torch.Tensor  # [Gc, 8] int64
    child_count: torch.Tensor  # [Gc, 8] int64
    gchild_com: torch.Tensor   # [Gc, 8, 8, 3]
    gchild_gmass: torch.Tensor # [Gc, 8, 8]
    gchild_diam_max: torch.Tensor  # [Gc, 8]
    gchild_complete: torch.Tensor  # [Gc, 8] bool: every grandchild
                               # segment of the child fits the c2 cap
    skin: torch.Tensor         # [Gc] max drift bound in cell
    child_skin: torch.Tensor   # [Gc, 8]
    n_cells: torch.Tensor      # [] int64
    n_child: torch.Tensor      # [] int64
    n_g2: torch.Tensor         # [] int64
    overflow: torch.Tensor     # [] bool: cut larger than Gc (missing mass)
    overflow_g2: torch.Tensor  # [] bool: grandchild cap overflow (graceful)


def max_depth_of(bits: int) -> int:
    return MAX_DEPTH_63 if bits == 63 else MAX_DEPTH


def _segment_ids(boundary: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(boundary.to(_I64), dim=0) - 1


def _seg_reduce(x: torch.Tensor, boundary: torch.Tensor, op: str):
    """Per-element value of its segment's `op` ("amin"/"amax") reduction
    of x [N] or [N, K]; segments start where boundary [N] is True.  (The
    JAX build's segmented running scans hold the same values at each
    segment's last element, the only place they are read.)"""
    seg = _segment_ids(boundary)
    idx = seg.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    out = torch.zeros_like(x)                 # >= the segment count rows
    out = out.scatter_reduce(0, idx, x, reduce=op, include_self=False)
    return out[seg]


def _cumsum_prefix(x: torch.Tensor) -> torch.Tensor:
    """P[k] = sum(x[:k]) in float64 for x [N, K]; [N+1, K].  The scan runs
    along the innermost axis of the transposed copy: a CUDA scan over the
    outer axis of a narrow [N, K] array is ~100x slower."""
    c = torch.cumsum(x.to(torch.float64).T.contiguous(), dim=1).T
    return torch.cat([c.new_zeros((1, x.shape[1])), c], dim=0)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 `x` (0 for 0)."""
    x = x.to(_I64)
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        hit = (x >> s) != 0
        x = torch.where(hit, x >> s, x)
        n = n + hit.to(_I64) * s
    return n + (x != 0).to(_I64)


def lcp_between(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Shared leading-bit prefix length of two `bits`-wide code arrays,
    counted from the top code bit: >= 3d means "same depth-d cell"."""
    return bits - bit_length(a ^ b)


def adjacent_lcp(codes_sorted: torch.Tensor, bits: int) -> torch.Tensor:
    """LCP with the left sorted neighbour; element 0 gets the full width."""
    prev = torch.cat([codes_sorted[:1], codes_sorted[:-1]])
    return lcp_between(codes_sorted, prev, bits)


def _block_cum(x: torch.Tensor, w: int, reverse: bool, fn) -> torch.Tensor:
    x = x.reshape(-1, w)
    if reverse:
        return fn(x.flip(1), dim=1).values.flip(1).reshape(-1)
    return fn(x, dim=1).values.reshape(-1)


def _sliding_cut_depth(lcp: torch.Tensor, b: int, max_depth: int) -> torch.Tensor:
    """UNCLAMPED cut depth per particle: cut(i) = floor(L(i)/3) + 1 with
    L(i) = max_{s in [i-b, i]} min(lcp[s+1 .. s+b]), both sliding extrema
    by the prefix/suffix block decomposition (nbody_tpu docstring)."""
    n = lcp.shape[0]
    dev = lcp.device
    if n <= b:
        return torch.zeros((n,), dtype=_I64, device=dev)

    def full(k, v):
        return torch.full((k,), v, dtype=_I64, device=dev)

    padw = (-n) % b if b > 1 else 0
    lp = torch.cat([lcp, full(padw, 64)]) if padw else lcp
    pre = _block_cum(lp, b, False, torch.cummin)
    suf = _block_cum(lp, b, True, torch.cummin)
    w_min = torch.minimum(suf[1:n - b + 1], pre[b:n])     # [n-b]
    wv = b + 1
    mp = torch.cat([full(b, -1), w_min, full(b + (-(n + b)) % wv, -1)])
    pre_m = _block_cum(mp, wv, False, torch.cummax)
    suf_m = _block_cum(mp, wv, True, torch.cummax)
    l_val = torch.maximum(suf_m[:n], pre_m[b:n + b])
    return torch.where(l_val < 0, 0, l_val // 3 + 1)


def _compact_axis(cid: torch.Tensor, axis_shift: int, levels: int):
    """Every third bit of cid >> axis_shift, `levels` bits, as float32."""
    i = torch.arange(levels, device=cid.device)
    bits = ((cid >> axis_shift)[:, None] >> (3 * i)) & 1
    return (bits << i).sum(dim=1).to(torch.float32)


def cell_corner(code: torch.Tensor, depth: torch.Tensor, lo: torch.Tensor,
                size: torch.Tensor, bits: int) -> torch.Tensor:
    """Lower corner (world coordinates) of the depth-d Morton cell that
    holds each `code`."""
    max_d = max_depth_of(bits)
    shift = 3 * (max_d - torch.clamp(depth, max=max_d))
    cid = (code >> shift) << shift
    xyz = torch.stack([_compact_axis(cid, 2, max_d),
                       _compact_axis(cid, 1, max_d),
                       _compact_axis(cid, 0, max_d)], dim=1)
    lattice = size / float(1 << max_d)
    return lo[None, :] + xyz * lattice


def build_source_cells(
    codes_sorted: torch.Tensor,
    pos_sorted: torch.Tensor,
    mass_sorted: torch.Tensor,
    b: int,
    g_const: float,
    g_cap: int,
    box_lo: Optional[torch.Tensor] = None,
    box_size: Optional[torch.Tensor] = None,
    drift_sorted: Optional[torch.Tensor] = None,
    g2_factor: int = 8,
    *,
    bits: int,
) -> SourceCells:
    """The adaptive cut with per-cell, per-child and per-grandchild
    monopoles.  With (box_lo, box_size), the cube the codes were
    quantized against, cell geometry is analytic (width = size/2^depth);
    without them it is each segment's particle bounding box.
    `drift_sorted` [N] attaches per-segment maximum drift bounds."""
    dev = codes_sorted.device
    n = codes_sorted.shape[0]
    idx = torch.arange(n, dtype=_I64, device=dev)
    c_cap = 8 * g_cap
    max_d = max_depth_of(bits)

    lcp = adjacent_lcp(codes_sorted, bits)
    cut_depth = _sliding_cut_depth(lcp, b, max_d)
    at_max = cut_depth >= max_d

    def run_start(flags):
        """Index of the last flagged row at or before each row (row 0 is
        always flagged): the start of each row's run."""
        seg = _segment_ids(flags)
        starts = torch.full_like(idx, -1).scatter_reduce(
            0, seg, torch.where(flags, idx, -1), reduce="amax")
        return starts[seg]

    first_b = idx == 0
    grp_b = first_b | (lcp < 3 * torch.clamp(cut_depth, max=max_d))
    bmax = first_b | (lcp < 3 * max_d)
    grp_b = grp_b | (at_max & ((idx - run_start(bmax)) % b == 0))

    chd_b = grp_b | (lcp < 3 * torch.clamp(cut_depth + 1, max=max_d))
    sub = max(b // 8, 1)
    chd_b = chd_b | (at_max & ((idx - run_start(grp_b)) % sub == 0))

    g2_b = chd_b | (lcp < 3 * torch.clamp(cut_depth + 2, max=max_d))
    sub2 = max(b // 64, 1)
    g2_b = g2_b | (at_max & ((idx - run_start(chd_b)) % sub2 == 0))

    grp_id = _segment_ids(grp_b)
    chd_id = _segment_ids(chd_b)
    g2_id = _segment_ids(g2_b)
    n_cells = grp_id[-1] + 1
    n_child = chd_id[-1] + 1
    n_g2 = g2_id[-1] + 1
    c2_cap = min(g2_factor, 8) * c_cap
    overflow = (n_cells > g_cap) | (n_child > c_cap)
    overflow_g2 = n_g2 > c2_cap

    big = torch.iinfo(torch.int32).max

    def compact_starts(flags, cap):
        skey = torch.sort(torch.where(flags, idx, big)).values
        if cap + 1 <= n:
            out = skey[: cap + 1]
        else:
            out = torch.cat([skey, torch.full((cap + 1 - n,), big,
                                              dtype=_I64, device=dev)])
        return torch.clamp(out, max=n)        # padding -> n

    def first_count(flags, cap):
        edges = compact_starts(flags, cap)
        first = edges[:cap]
        return first, torch.clamp(edges[1:] - first, 0, n)

    g_first, g_count = first_count(grp_b, g_cap)
    c_first, c_count = first_count(chd_b, c_cap)
    c2_first, c2_count = first_count(g2_b, c2_cap)

    pmw = _cumsum_prefix(torch.cat([mass_sorted[:, None],
                                    pos_sorted * mass_sorted[:, None]], dim=1))
    analytic = box_lo is not None and box_size is not None
    if not analytic:
        def minmax(flags):
            return (_seg_reduce(pos_sorted, flags, "amin"),
                    _seg_reduce(pos_sorted, flags, "amax"))

        mn_g, mx_g = minmax(grp_b)
        mn_c, mx_c = minmax(chd_b)
        mn_g2, mx_g2 = minmax(g2_b)

    def seg_moments(first, count):
        valid = count > 0
        fc = torch.clamp(first, 0, n - 1)
        d = pmw[torch.clamp(first + count, 0, n)] - pmw[fc]      # float64
        m = d[:, 0]
        com = torch.where(valid[:, None],
                          d[:, 1:4] / torch.clamp(m, min=1e-20)[:, None], 0.0)
        m32 = m.to(torch.float32)
        return com.to(torch.float32), g_const * m32 * valid

    def last_of(first, count):
        return torch.clamp(first + count - 1, 0, n - 1)

    def bbox_stats(first, count, mn, mx):
        valid = count > 0
        lastp = last_of(first, count)
        lo = torch.where(valid[:, None], mn[lastp], _BIG_F)
        hi = torch.where(valid[:, None], mx[lastp], -_BIG_F)
        diam = torch.where(valid, (mx[lastp] - mn[lastp]).amax(dim=1), 0.0)
        return diam, lo, hi

    def analytic_stats(first, count, depth):
        valid = count > 0
        fc = torch.clamp(first, 0, n - 1)
        width = torch.where(
            valid,
            box_size * torch.exp2(-torch.clamp(depth, max=max_d).to(torch.float32)),
            0.0,
        )
        corner = cell_corner(codes_sorted[fc], depth, box_lo, box_size, bits)
        lo = torch.where(valid[:, None], corner, _BIG_F)
        hi = torch.where(valid[:, None], corner + width[:, None], -_BIG_F)
        return width, lo, hi

    g_com, g_gm = seg_moments(g_first, g_count)
    c_com, c_gm = seg_moments(c_first, c_count)
    c2_com, c2_gm = seg_moments(c2_first, c2_count)

    if drift_sorted is not None:
        mxd_g = _seg_reduce(drift_sorted, grp_b, "amax")
        mxd_c = _seg_reduce(drift_sorted, chd_b, "amax")
        g_skin = torch.where(g_count > 0, mxd_g[last_of(g_first, g_count)], 0.0)
        c_skin = torch.where(c_count > 0, mxd_c[last_of(c_first, c_count)], 0.0)
    else:
        g_skin = torch.zeros((g_cap,), dtype=torch.float32, device=dev)
        c_skin = torch.zeros((c_cap,), dtype=torch.float32, device=dev)

    if analytic:
        def depth_at(first, extra):
            return torch.clamp(cut_depth[torch.clamp(first, 0, n - 1)] + extra,
                               max=max_d)

        g_diam, g_lo, g_hi = analytic_stats(g_first, g_count, depth_at(g_first, 0))
        c_diam, _, _ = analytic_stats(c_first, c_count, depth_at(c_first, 1))
        c2_diam, _, _ = analytic_stats(c2_first, c2_count, depth_at(c2_first, 2))
    else:
        g_diam, g_lo, g_hi = bbox_stats(g_first, g_count, mn_g, mx_g)
        c_diam, _, _ = bbox_stats(c_first, c_count, mn_c, mx_c)
        c2_diam, _, _ = bbox_stats(c2_first, c2_count, mn_g2, mx_g2)

    arange8 = torch.arange(8, dtype=_I64, device=dev)

    def regroup(parent_first, parent_count, kid_id, kid_cap, n_kid_total):
        """Parent i's kids are the contiguous kid ids [kid_id[first[i]],
        kid_id[first[i+1]]), in <= 8 slots; a slot past the kid cap is
        DROPPED (never clipped onto another segment)."""
        valid = parent_count > 0
        pf = torch.clamp(parent_first, 0, n - 1)
        base = torch.where(valid, kid_id[pf], n_kid_total)
        nxt = torch.cat([base[1:], base.new_zeros(1)])
        nxt_valid = torch.cat([valid[1:], valid.new_zeros(1)])
        nxt = torch.where(nxt_valid, nxt, n_kid_total)
        n_kids = torch.clamp(torch.where(valid, nxt - base, 0), 0, 8)
        raw = base[:, None] + arange8[None, :]
        ok = (arange8[None, :] < n_kids[:, None]) & (raw < kid_cap)
        slot = torch.clamp(raw, 0, kid_cap - 1)
        complete = valid & (base + n_kids <= kid_cap)
        return slot, ok, complete

    def take(x, slot, ok):
        v = x[slot]
        okb = ok.view(ok.shape + (1,) * (v.dim() - ok.dim()))
        return torch.where(okb, v, torch.zeros((), dtype=v.dtype, device=dev))

    valid_g = g_count > 0
    slot_c, kid_ok, _ = regroup(g_first, g_count, chd_id, c_cap, n_child)
    child_diam = take(c_diam, slot_c, kid_ok)

    slot_2, ok_2, complete_2 = regroup(c_first, c_count, g2_id, c2_cap, n_g2)
    gc_com_f = take(c2_com, slot_2, ok_2)                     # [Cc, 8, 3]
    gc_gm_f = take(c2_gm, slot_2, ok_2)                       # [Cc, 8]
    gdm_f = take(c2_diam, slot_2, ok_2).amax(dim=1)           # [Cc]

    return SourceCells(
        first=torch.where(valid_g, g_first, 0),
        count=g_count,
        com=g_com,
        gmass=g_gm,
        diam=g_diam,
        lo=g_lo,
        hi=g_hi,
        child_com=take(c_com, slot_c, kid_ok),
        child_gmass=take(c_gm, slot_c, kid_ok),
        child_diam=child_diam,
        child_diam_max=child_diam.amax(dim=1),
        child_first=take(c_first, slot_c, kid_ok),
        child_count=take(c_count, slot_c, kid_ok),
        gchild_com=take(gc_com_f, slot_c, kid_ok),
        gchild_gmass=take(gc_gm_f, slot_c, kid_ok),
        gchild_diam_max=take(gdm_f, slot_c, kid_ok),
        gchild_complete=kid_ok & complete_2[slot_c],
        skin=torch.where(valid_g, g_skin, 0.0),
        child_skin=take(c_skin, slot_c, kid_ok),
        n_cells=n_cells,
        n_child=n_child,
        n_g2=n_g2,
        overflow=overflow,
        overflow_g2=overflow_g2,
    )
