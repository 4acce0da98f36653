"""Adaptive octree source cells from sorted Morton codes.

Port of nbody_tpu/ops/cells.py (see there for the derivation): for every
particle the shallowest depth whose Morton cell holds <= B particles,
computed from two sliding-window extrema over the adjacent-LCP array;
cells, their depth+1 children and depth+2 grandchildren are contiguous
runs of the sorted order, compacted to static capacities, with monopoles
from prefix sums and analytic (lattice) geometry.  The multi-device path
builds each shard's cells from a window of the sorted arrays
(`build_source_cells_window`, with the one cross-shard carry from
`last_bmax_boundary`); both builds share their segment statistics.

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


# What a cut demands of the static capacities: the cell slots (its cells,
# or an eighth of its children where those are more, since each cell has 8
# child slots) and the grandchild segments.  build_source_cells' overflow
# is the first past g_cap, overflow_g2 the second past the grandchild cap.
CELL_DEMAND = ("cells", "g2")


def capacity_demand(cells: SourceCells) -> torch.Tensor:
    """int64 [2]: the CELL_DEMAND of one cut."""
    return torch.stack([torch.maximum(cells.n_cells, (cells.n_child + 7) // 8),
                        cells.n_g2])


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


def _sliding_cut_depth(lcp: torch.Tensor, b: int, max_depth: int,
                       x_off: Optional[int] = None,
                       n_total: Optional[int] = None) -> torch.Tensor:
    """UNCLAMPED cut depth per particle: cut(i) = floor(L(i)/3) + 1 with
    L(i) = max_{s in [i-b, i]} min(lcp[s+1 .. s+b]), both sliding extrema
    by the prefix/suffix block decomposition (nbody_tpu docstring).

    Windowed use (build_source_cells_window): `lcp` covers a window of a
    longer array whose row 0 is global row `x_off`; windows whose global
    start leaves [1, n_total - b] are invalidated, as the global
    computation's out-of-range padding does, so the window's edge-pad
    rows fabricate no deeper cut."""
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
    if n_total is not None:
        xg = torch.arange(1, n - b + 1, device=dev) + x_off
        w_min = torch.where((xg >= 1) & (xg <= n_total - b), w_min, -1)
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


def _boundary_flags(lcp: torch.Tensor, cut_depth: torch.Tensor, b: int,
                    max_d: int):
    """(cell, child, grandchild) run-start flags [N] from the adjacent
    LCPs and the unclamped cut depth: a level's run starts where the
    neighbours part above its depth, and inside one finest-cell run every
    b (b/8, b/64) rows from the run's start (row 0 always)."""
    idx = torch.arange(lcp.shape[0], dtype=_I64, device=lcp.device)
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
    return grp_b, chd_b, g2_b


def _compact_starts(flags: torch.Tensor, cap: int) -> torch.Tensor:
    """The first cap + 1 flagged rows ascending, padded with N: [cap + 1]
    run edges (run i is rows [e[i], e[i+1]))."""
    n = flags.shape[0]
    idx = torch.arange(n, dtype=_I64, device=flags.device)
    big = torch.iinfo(torch.int32).max
    skey = torch.sort(torch.where(flags, idx, big)).values
    if cap + 1 <= n:
        out = skey[: cap + 1]
    else:
        out = torch.cat([skey, skey.new_full((cap + 1 - n,), big)])
    return torch.clamp(out, max=n)        # padding -> n


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
    n = codes_sorted.shape[0]
    c_cap = 8 * g_cap
    max_d = max_depth_of(bits)

    lcp = adjacent_lcp(codes_sorted, bits)
    cut_depth = _sliding_cut_depth(lcp, b, max_d)
    grp_b, chd_b, g2_b = _boundary_flags(lcp, cut_depth, b, max_d)

    grp_id = _segment_ids(grp_b)
    chd_id = _segment_ids(chd_b)
    g2_id = _segment_ids(g2_b)
    n_cells = grp_id[-1] + 1
    n_child = chd_id[-1] + 1
    n_g2 = g2_id[-1] + 1
    c2_cap = min(g2_factor, 8) * c_cap
    overflow = (n_cells > g_cap) | (n_child > c_cap)
    overflow_g2 = n_g2 > c2_cap

    def first_count(flags, cap):
        edges = _compact_starts(flags, cap)
        first = edges[:cap]
        return (first, torch.clamp(edges[1:] - first, 0, n),
                torch.clamp(first, 0, n - 1))

    return _cells_from_runs(
        codes_sorted, pos_sorted, mass_sorted, cut_depth, (grp_b, chd_b, g2_b),
        (first_count(grp_b, g_cap), first_count(chd_b, c_cap),
         first_count(g2_b, c2_cap)),
        (chd_id, g2_id), (n_child, n_g2), g_const, box_lo, box_size,
        drift_sorted, bits, n_cells, overflow, overflow_g2)


def _cells_from_runs(codes, pos, mass, cut_depth, flags, runs, kid_ids,
                     n_kids, g_const, box_lo, box_size, drift, bits, n_cells,
                     overflow, overflow_g2) -> SourceCells:
    """Monopoles, geometry, skins and kid slots of the compacted cell,
    child and grandchild runs; the part both builds share.

    flags: the three levels' boundary flags over the array (row 0
    flagged); runs: per level (first, count, row) per slot, the run's
    first particle as stored, its particle count (0 in a pad slot) and
    the array row of its first particle; kid_ids: the child and the
    grandchild run id of each array row; n_kids: their totals."""
    dev = codes.device
    n = codes.shape[0]
    max_d = max_depth_of(bits)
    grp_b, chd_b, g2_b = flags
    (g_first, g_count, g_row), (c_first, c_count, c_row), (
        c2_first, c2_count, c2_row) = runs
    chd_id, g2_id = kid_ids
    n_child, n_g2 = n_kids
    g_cap, c_cap, c2_cap = (g_first.shape[0], c_first.shape[0],
                            c2_first.shape[0])

    pmw = _cumsum_prefix(torch.cat([mass[:, None], pos * mass[:, None]], 1))
    analytic = box_lo is not None and box_size is not None

    def seg_moments(row, count):
        valid = count > 0
        d = pmw[torch.clamp(row + count, 0, n)] - pmw[row]       # float64
        m = d[:, 0]
        com = torch.where(valid[:, None],
                          d[:, 1:4] / torch.clamp(m, min=1e-20)[:, None], 0.0)
        m32 = m.to(torch.float32)
        return com.to(torch.float32), g_const * m32 * valid

    def last_row(row, count):
        return torch.clamp(row + count - 1, 0, n - 1)

    def bbox_stats(row, count, level):
        valid = count > 0
        mn = _seg_reduce(pos, flags[level], "amin")
        mx = _seg_reduce(pos, flags[level], "amax")
        lastp = last_row(row, count)
        lo = torch.where(valid[:, None], mn[lastp], _BIG_F)
        hi = torch.where(valid[:, None], mx[lastp], -_BIG_F)
        diam = torch.where(valid, (mx[lastp] - mn[lastp]).amax(dim=1), 0.0)
        return diam, lo, hi

    def analytic_stats(row, count, level):
        valid = count > 0
        depth = torch.clamp(cut_depth[row] + level, max=max_d)
        width = torch.where(
            valid, box_size * torch.exp2(-depth.to(torch.float32)), 0.0)
        corner = cell_corner(codes[row], depth, box_lo, box_size, bits)
        lo = torch.where(valid[:, None], corner, _BIG_F)
        hi = torch.where(valid[:, None], corner + width[:, None], -_BIG_F)
        return width, lo, hi

    g_com, g_gm = seg_moments(g_row, g_count)
    c_com, c_gm = seg_moments(c_row, c_count)
    c2_com, c2_gm = seg_moments(c2_row, c2_count)

    if drift is not None:
        mxd_g = _seg_reduce(drift, grp_b, "amax")
        mxd_c = _seg_reduce(drift, chd_b, "amax")
        g_skin = torch.where(g_count > 0, mxd_g[last_row(g_row, g_count)], 0.0)
        c_skin = torch.where(c_count > 0, mxd_c[last_row(c_row, c_count)], 0.0)
    else:
        g_skin = torch.zeros((g_cap,), dtype=torch.float32, device=dev)
        c_skin = torch.zeros((c_cap,), dtype=torch.float32, device=dev)

    stats = analytic_stats if analytic else bbox_stats
    g_diam, g_lo, g_hi = stats(g_row, g_count, 0)
    c_diam, _, _ = stats(c_row, c_count, 1)
    c2_diam, _, _ = stats(c2_row, c2_count, 2)

    arange8 = torch.arange(8, dtype=_I64, device=dev)

    def regroup(parent_row, parent_count, kid_id, kid_cap, n_kid_total):
        """Parent i's kids are the contiguous kid ids [kid_id[first[i]],
        kid_id[first[i+1]]), in <= 8 slots; a slot past the kid cap is
        DROPPED (never clipped onto another segment)."""
        valid = parent_count > 0
        base = torch.where(valid, kid_id[parent_row], n_kid_total)
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
    slot_c, kid_ok, _ = regroup(g_row, g_count, chd_id, c_cap, n_child)
    child_diam = take(c_diam, slot_c, kid_ok)

    slot_2, ok_2, complete_2 = regroup(c_row, c_count, g2_id, c2_cap, n_g2)
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


# ---------------------------------------------------------------------------
# The owner-computes shard of the cut (parallel/shard.py)
# ---------------------------------------------------------------------------


def last_bmax_boundary(codes_own: torch.Tensor, left_code: torch.Tensor,
                       idx0: int, bits: int) -> torch.Tensor:
    """Global index of the LAST max-depth run boundary within the owned
    rows [idx0, idx0 + len(codes_own)), or -1 if none (a device scalar).
    `left_code` is the global left neighbour of row idx0 (row idx0 - 1;
    any code when idx0 == 0, which is a boundary anyway).  The one cut
    carry with unbounded reach: a single finest-cell run can span
    shards."""
    prev = torch.cat([left_code.reshape(1), codes_own[:-1]])
    lcp = lcp_between(codes_own, prev, bits)
    idx = torch.arange(codes_own.shape[0], dtype=_I64,
                       device=codes_own.device) + idx0
    bmax = (idx == 0) | (lcp < 3 * max_depth_of(bits))
    return torch.where(bmax, idx, -1).max()


def build_source_cells_window(
    codes_sorted: torch.Tensor,
    pos_sorted: torch.Tensor,
    mass_sorted: torch.Tensor,
    b: int,
    g_const: float,
    g_cap_shard: int,
    start: int,
    own: int,
    n_total: int,
    bmax_carry,
    box_lo: torch.Tensor,
    box_size: torch.Tensor,
    drift_sorted: Optional[torch.Tensor] = None,
    g2_factor: int = 8,
    *,
    bits: int,
) -> SourceCells:
    """The cells whose FIRST particle lies in the owned rows [start,
    start + own), built from a window of the sorted arrays centred on
    them (global rows start - lead .. start + own + lead - 1, edge-padded
    past the array's ends; lead = 4b in parallel/shard.py).

    The cut depth at a row depends only on the adjacent LCPs within
    b + 1 rows of it, so a halo of more than 2b + 1 rows on each side
    reproduces the global flags on every owned row; the one carry with
    unbounded reach is the last max-depth run boundary before the owned
    rows (`bmax_carry`, a device scalar or int, from last_bmax_boundary
    over the earlier shards: inside one finest-cell run the b-run splits
    are phase-locked to it).  An owned cell's child and grandchild runs
    end at most b rows past the owned rows, inside the right halo.

    Returns per-shard SourceCells: capacity g_cap_shard, the owned cells
    packed to a live prefix, n_cells the owned count, `first` and
    `child_first` global rows.  Shards' cells concatenated in shard order
    are the global build's; integer fields are identical to it and
    moments differ by float64 prefix rounding (window-local sums)."""
    dev = codes_sorted.device
    n_win = codes_sorted.shape[0]
    lead = (n_win - own) // 2
    x0 = start - lead                                   # global row of row 0
    idx = torch.arange(n_win, dtype=_I64, device=dev) + x0
    c_cap = 8 * g_cap_shard
    max_d = max_depth_of(bits)

    lcp = adjacent_lcp(codes_sorted, bits)
    cut_depth = _sliding_cut_depth(lcp, b, max_d, x_off=x0, n_total=n_total)
    at_max = cut_depth >= max_d

    def run_start(flags):
        return torch.cummax(torch.where(flags, idx, -1), dim=0).values

    first_b = idx == 0
    grp_b = first_b | (lcp < 3 * torch.clamp(cut_depth, max=max_d))
    bmax = first_b | (lcp < 3 * max_d)
    st_max = torch.maximum(run_start(bmax), torch.as_tensor(bmax_carry,
                                                            device=dev))
    grp_b = grp_b | (at_max & ((idx - st_max) % b == 0))

    chd_b = grp_b | (lcp < 3 * torch.clamp(cut_depth + 1, max=max_d))
    sub = max(b // 8, 1)
    grp_start = run_start(grp_b)
    chd_b = chd_b | (at_max & ((idx - grp_start) % sub == 0))

    g2_b = chd_b | (lcp < 3 * torch.clamp(cut_depth + 2, max=max_d))
    sub2 = max(b // 64, 1)
    g2_b = g2_b | (at_max & ((idx - run_start(chd_b)) % sub2 == 0))

    # a run belongs to this shard iff its CELL starts in the owned rows
    # (the last owned cell's child runs may start in the right halo)
    owner = (grp_start >= start) & (grp_start < start + own)
    own_grp, own_chd, own_g2 = grp_b & owner, chd_b & owner, g2_b & owner
    n_cells = own_grp.sum()
    n_child = own_chd.sum()
    n_g2 = own_g2.sum()
    c2_cap = min(g2_factor, 8) * c_cap
    overflow = (n_cells > g_cap_shard) | (n_child > c_cap)
    overflow_g2 = n_g2 > c2_cap

    big = torch.iinfo(torch.int32).max

    def next_boundary(flags):
        """The first same-level boundary AFTER each row (global row)."""
        key = torch.where(flags, idx, big).flip(0)
        nxt = torch.cummin(key, dim=0).values.flip(0)
        return torch.cat([nxt[1:], nxt.new_full((1,), big)])

    # runs end at the next boundary, clamped to the window and to the
    # array (the last shard's right pad rows repeat the last code, so its
    # final cell would otherwise take them)
    end_win = min(x0 + n_win, n_total)

    def compact(flags, level_flags, cap):
        skey = torch.sort(torch.where(flags, idx, big)).values
        if cap <= n_win:
            firsts = skey[:cap]
        else:
            firsts = torch.cat([skey, skey.new_full((cap - n_win,), big)])
        live = firsts < big
        row = torch.clamp(firsts - x0, 0, n_win - 1)
        ends = torch.clamp(next_boundary(level_flags)[row], max=end_win)
        return (torch.where(live, firsts, 0),
                torch.where(live, ends - firsts, 0), row)

    # the segment reductions need row 0 flagged; the partial run before
    # the first boundary is never owned
    lead_b = torch.arange(n_win, device=dev) == 0
    return _cells_from_runs(
        codes_sorted, pos_sorted, mass_sorted, cut_depth,
        (grp_b | lead_b, chd_b | lead_b, g2_b | lead_b),
        (compact(own_grp, grp_b, g_cap_shard), compact(own_chd, chd_b, c_cap),
         compact(own_g2, g2_b, c2_cap)),
        (torch.cumsum(own_chd.to(_I64), 0) - 1,
         torch.cumsum(own_g2.to(_I64), 0) - 1),
        (n_child, n_g2), g_const, box_lo, box_size, drift_sorted, bits,
        n_cells, overflow, overflow_g2)
