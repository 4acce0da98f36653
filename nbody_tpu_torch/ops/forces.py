"""Gravity forces: the direct O(N^2) oracle, the per-particle rope walk
over the escape-linearised tree (the Barnes-Hut oracle) and the
production Barnes-Hut band decomposition (port of
nbody_tpu/ops/forces.py; the design rationale is in that module's
section comment).

Production path, per step on Morton-sorted, tile-padded particles:
adaptive source cells -> supers (8 cells) -> super-supers (8 supers) ->
per-tile band lists (ss / sup / mid / cmid / near children and their
deduplicated 128-wide source windows) -> per-tile planar tables, then
three sweeps: the far sweep over the super-super monopoles, the table
sweep over each tile's table row, and the exact near P2P over each
tile's windows.  The sweeps run as the CUDA kernels of
``ops/cuda/forces.py`` and the band lists as the kernel of
``ops/cuda/classify.py`` when ``cfg.use_pallas`` is set, and as the plain
PyTorch versions here otherwise.

Port notes: the classification and the tables work over the static caps
(every list at its cap width, entries past the live count being pad
keys), so building them reads nothing back from the device; the band
reuse runner's one host read per rebuild is its validity horizon.  Row
compaction uses ``torch.sort`` (stable where ties can occur), and the
segmented OR of window mask words is a segmented integer sum (the pieces
merged into one window cover disjoint lanes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import bbox as _bbox
from nbody_tpu_torch.ops.cells import build_source_cells, lcp_between
from nbody_tpu_torch.ops.tree import LinearTree

_I64 = torch.int64
_I32 = torch.int32
_BIG_F = 3.0e38

# Near-band windows: every near child's run is split at SPAN_ALIGN
# particle boundaries, so each piece lies in ONE aligned window.
SPAN_ALIGN = 128
# Sub-spheres per target tile for the min-gap MAC.
SUB_FACTOR = 8
# Element budget of one plain-sweep panel (targets x sources).
_PANEL_ELEMS = 1 << 25
# What a band build demands of each list, the longest over tiles: the raw
# counts of the five band lists and the near children's distinct windows
# (the lengths that would hold every entry), in cell_band_lists' `demand`.
BAND_DEMAND = ("ss", "sup", "mid", "cmid", "near", "win")


def soft_term(cfg: SimConfig) -> float:
    """The additive term inside the sqrt: SOFTENING (v5) or SOFTENING^2
    (legacy)."""
    return cfg.softening**2 if cfg.legacy_softening else cfg.softening


# absent-entry sentinel of the band key arrays (even, as in the JAX package)
_BIG = torch.iinfo(torch.int32).max // 2 * 2


# ---------------------------------------------------------------------------
# Direct O(N^2)
# ---------------------------------------------------------------------------


def _sum_terms(w, dx, dy, dz):
    """Sum the force terms w*d over the last axis: each term rounded in
    the inputs' precision, the sum taken in float64 (the band sweeps'
    terms cancel across bands; see the numerics note in
    csrc/tile_sweeps.cu)."""
    return torch.stack([(w * d).sum(dim=-1, dtype=torch.float64)
                        for d in (dx, dy, dz)], dim=-1).to(w.dtype)


def _panel_accel(pos_blk, pos_all, mass_all, g, soft):
    """Acceleration of a (B, 3) block against (N, 3) sources with explicit
    coordinate differences (the |p|^2+|q|^2-2pq form loses close pairs to
    float32 cancellation at galaxy coordinate scales)."""
    dx = pos_all[None, :, 0] - pos_blk[:, None, 0]
    dy = pos_all[None, :, 1] - pos_blk[:, None, 1]
    dz = pos_all[None, :, 2] - pos_blk[:, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    inv = 1.0 / torch.sqrt(d2 + soft)
    w = (g * mass_all)[None, :] * (inv * inv * inv)
    return _sum_terms(w, dx, dy, dz)


def direct_forces(pos: torch.Tensor, mass: torch.Tensor, cfg: SimConfig,
                  block: int = 1024) -> torch.Tensor:
    """All-pairs gravity in (block x block) panels; the self term adds
    exactly zero (d = 0)."""
    g, soft = cfg.g, soft_term(cfg)
    n = pos.shape[0]
    src_block = max(block, _PANEL_ELEMS // max(block, 1))
    out = []
    for i in range(0, n, block):
        pb = pos[i:i + block]
        acc = torch.zeros_like(pb)
        for j in range(0, n, src_block):
            acc += _panel_accel(pb, pos[j:j + src_block],
                                mass[j:j + src_block], g, soft)
        out.append(acc)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Barnes-Hut: the per-particle rope walk (the oracle of the tiled path)
# ---------------------------------------------------------------------------


def bh_forces_reference(pos_sorted: torch.Tensor, tree: LinearTree,
                        cfg: SimConfig, block: int = 256,
                        stats: dict | None = None) -> torch.Tensor:
    """Stackless walk of the escape-linearised tree for every particle,
    accept rule width / dist < theta (leaves have width 0 and are always
    accepted; a particle's own leaf adds zero): accept -> jump to the
    escape index, open -> step to +1.

    All walks advance in lockstep, one node per iteration each.  Every
    `block` iterations the finished walks leave the live set, and that
    compaction is the one host read of the block.  With `stats`, adds the
    lockstep iterations run and the host reads made to
    stats["iterations"] and stats["host_reads"]."""
    m_nodes = tree.n_nodes
    g, soft, theta = cfg.g, soft_term(cfg), cfg.theta
    n = pos_sorted.shape[0]
    out = torch.zeros_like(pos_sorted)
    idx = torch.arange(n, device=pos_sorted.device)
    p, acc = pos_sorted, torch.zeros_like(pos_sorted)
    ptr = torch.zeros(n, dtype=_I64, device=pos_sorted.device)
    iters = reads = 0
    while idx.numel():
        for _ in range(block):
            # a finished walk reads the inert last entry: mass 0 adds 0
            q = ptr.clamp(max=m_nodes)
            d = tree.com[q] - p
            dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                              + d[:, 2] * d[:, 2] + soft)
            accept = tree.width[q] / dist < theta
            f = g * tree.mass[q] / (dist * dist * dist)
            acc = torch.where(accept[:, None], acc + f[:, None] * d, acc)
            ptr = torch.where(accept, tree.escape[q], ptr + 1)
        iters += block
        out[idx] = acc
        keep = torch.nonzero(ptr < m_nodes).squeeze(1)
        reads += 1
        idx, p, acc, ptr = idx[keep], p[keep], acc[keep], ptr[keep]
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + iters
        stats["host_reads"] = stats.get("host_reads", 0) + reads
    return out


# ---------------------------------------------------------------------------
# Target tiles and source aggregates
# ---------------------------------------------------------------------------


class GroupInfo(NamedTuple):
    """Bounding spheres of the target tiles' sub-blocks."""

    center: torch.Tensor   # [T*8, 3]
    radius: torch.Tensor   # [T*8]
    skin: torch.Tensor     # [T*8] max drift bound (0 = live)


def pad_to_groups(pos_s, mass_s, b):
    """Pad sorted arrays to a multiple of b with zero-mass clones of the
    last particle."""
    n = pos_s.shape[0]
    n_pad = -(-n // b) * b
    if n_pad == n:
        return pos_s, mass_s
    pos_p = torch.cat([pos_s, pos_s[-1:].expand(n_pad - n, 3)])
    mass_p = torch.cat([mass_s, mass_s.new_zeros(n_pad - n)])
    return pos_p, mass_p


def pad_sorted(pos_s, mass_s, codes_s, b):
    """pad_to_groups plus the matching int64 Morton codes (clones of the
    last code keep the order sorted)."""
    n = pos_s.shape[0]
    pos_p, mass_p = pad_to_groups(pos_s, mass_s, b)
    n_pad = pos_p.shape[0]
    if n_pad == n:
        return pos_p, mass_p, codes_s
    return pos_p, mass_p, torch.cat([codes_s, codes_s[-1:].expand(n_pad - n)])


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3, summed left to right."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def local_width(codes_s: torch.Tensor, box_size: torch.Tensor, b: int,
                bits: int) -> torch.Tensor:
    """Per-particle local cell width from the sorted int64 Morton keys:
    box_size * 2^-depth of the smallest Morton cell holding the particle
    and its neighbour b/8 positions away on either side (the child-cell
    occupancy scale).  The adaptive runner caps skin margins with it."""
    c = max(b // 8, 1)
    left = torch.cat([codes_s[:1].expand(c), codes_s[:-c]])
    right = torch.cat([codes_s[c:], codes_s[-1:].expand(c)])
    d = torch.maximum(lcp_between(codes_s, left, bits),
                      lcp_between(codes_s, right, bits)) // 3
    return box_size * torch.exp2(-d.to(torch.float32))


def target_subspheres(pos_s: torch.Tensor, b: int,
                      drift: torch.Tensor | None = None,
                      codes: torch.Tensor | None = None,
                      bits: int | None = None) -> GroupInfo:
    """Bounding spheres of each tile's SUB_FACTOR sub-blocks, [T*8].

    With `codes` (sorted int64 Morton keys of `bits` width), the 7
    internal boundaries sit at the tile's 7 smallest adjacent LCPs, ties
    to the lower index (a stable sort; the JAX package's lax.top_k breaks
    ties the same way); otherwise at fixed b/8 strides."""
    t = pos_s.shape[0] // b
    dev = pos_s.device
    if codes is None:
        sb = b // SUB_FACTOR
        p3 = pos_s.reshape(-1, sb, 3)
        lo, hi = p3.amin(dim=1), p3.amax(dim=1)
        skin = (torch.zeros(p3.shape[0], device=dev) if drift is None
                else drift.reshape(-1, sb).amax(dim=1))
        return GroupInfo(center=0.5 * (lo + hi), radius=0.5 * _norm3(hi - lo),
                         skin=skin)
    if bits is None:
        raise ValueError("target_subspheres needs the code width with codes")

    nxt = torch.cat([codes[1:], codes[-1:]])
    lcp = lcp_between(codes, nxt, bits).reshape(t, b)[:, : b - 1]
    splits = torch.sort(lcp, dim=1, stable=True).indices[:, : SUB_FACTOR - 1]
    splits = torch.sort(splits, dim=1).values                    # [t, 7]
    lane = torch.arange(b, device=dev)
    seg = (lane[None, :, None] > splits[:, None, :]).sum(dim=-1)  # [t, b]
    sid = (seg + SUB_FACTOR * torch.arange(t, device=dev)[:, None]).reshape(-1)
    sidx = sid[:, None].expand(-1, 3)
    lo = torch.full((t * SUB_FACTOR, 3), _BIG_F, device=dev).scatter_reduce(
        0, sidx, pos_s, reduce="amin")
    hi = torch.full((t * SUB_FACTOR, 3), -_BIG_F, device=dev).scatter_reduce(
        0, sidx, pos_s, reduce="amax")
    skin = torch.zeros(t * SUB_FACTOR, device=dev)
    if drift is not None:
        skin = skin.scatter_reduce(0, sid, drift, reduce="amax")
    # distinct boundary positions: every segment holds >= 1 particle
    return GroupInfo(center=0.5 * (lo + hi), radius=0.5 * _norm3(hi - lo),
                     skin=skin)


class Supers(NamedTuple):
    """Level-2/3 source aggregates: supers (8 cells) or super-supers (8
    supers, the far sweep's source level; it reads com, gmass, n_supers)."""

    com: torch.Tensor       # [S, 3]
    gmass: torch.Tensor     # [S]
    diam: torch.Tensor      # [S] max bbox extent over members
    lo: torch.Tensor        # [S, 3]
    hi: torch.Tensor        # [S, 3]
    skin: torch.Tensor      # [S]
    n_supers: torch.Tensor  # [] int64 live count (ceil(n_live / 8))


def _sum8(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (size 8), left to right."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _aggregate8(com, gmass, lo, hi, skin, n_live) -> Supers:
    """8-to-1 aggregation: mass-weighted COM, bbox union, skin max
    (member arrays a multiple of 8 long, live members a prefix)."""
    s = gmass.shape[0] // 8
    gm = gmass.reshape(s, 8)
    msum = _sum8(gm)
    c = _sum8(com.reshape(s, 8, 3) * gm[..., None]) / torch.clamp(
        msum, min=1e-20)[:, None]
    alo = lo.reshape(s, 8, 3).amin(dim=1)
    ahi = hi.reshape(s, 8, 3).amax(dim=1)
    valid = msum > 0
    return Supers(
        com=torch.where(valid[:, None], c, 0.0),
        gmass=msum,
        diam=torch.where(valid, (ahi - alo).amax(dim=1), 0.0),
        lo=alo,
        hi=ahi,
        skin=skin.reshape(s, 8).amax(dim=1),
        n_supers=(n_live + 7) // 8,
    )


def make_supers(cells) -> Supers:
    return _aggregate8(cells.com, cells.gmass, cells.lo, cells.hi,
                       cells.skin, cells.n_cells)


def make_supersupers(supers: Supers) -> Supers:
    """Level-3 aggregates: 8 consecutive supers (64 cells) each."""
    s = supers.gmass.shape[0]
    pad = -(-s // 8) * 8 - s
    if pad:
        def p(x, v=0.0):
            return torch.cat([x, torch.full((pad,) + x.shape[1:], v,
                                            dtype=x.dtype, device=x.device)])
        supers = Supers(com=p(supers.com), gmass=p(supers.gmass),
                        diam=p(supers.diam), lo=p(supers.lo, _BIG_F),
                        hi=p(supers.hi, -_BIG_F), skin=p(supers.skin),
                        n_supers=supers.n_supers)
    return _aggregate8(supers.com, supers.gmass, supers.lo, supers.hi,
                       supers.skin, supers.n_supers)


def make_ss(supers: Supers, cfg: SimConfig) -> Supers:
    """The far sweep's top source level: super-supers, or with cfg.no_ss
    the same aggregates with diam forced huge, so every live SS fails its
    MAC and telescopes to its member supers.  no_ss needs every SS to fit
    a tile's ss list (ss_cap >= n_ss), else an overflowed SS would keep
    the monopole no_ss is meant to remove."""
    ss = make_supersupers(supers)
    if cfg.no_ss:
        n_ss = ss.gmass.shape[0]
        if cfg.ss_cap < n_ss:
            raise ValueError(f"no_ss needs ss_cap >= n_ss: ss_cap="
                             f"{cfg.ss_cap} < n_ss={n_ss}")
        ss = ss._replace(diam=torch.where(ss.gmass > 0, _BIG_F, ss.diam))
    return ss


# ---------------------------------------------------------------------------
# Band classification
# ---------------------------------------------------------------------------


class CellBands(NamedTuple):
    """Per-tile source classification (field meanings as in
    nbody_tpu.ops.forces.CellBands); index lists are int32, live-prefix
    packed, with pads at the class's zero row."""

    ss_idx: torch.Tensor     # [T, ss_cap] super-super ids (pad n_ss)
    ss_cnt: torch.Tensor
    sup_idx: torch.Tensor    # [T, sup_cap] super ids (pad n_sup)
    sup_cnt: torch.Tensor
    mid_idx: torch.Tensor    # [T, mid_cap] cell ids (pad g_cap)
    mid_cnt: torch.Tensor
    cmid_idx: torch.Tensor   # [T, cmid_cap] child ids 8*cell+slot (pad 8*g_cap)
    cmid_cnt: torch.Tensor
    near_idx: torch.Tensor   # [T, near_cap] child ids (pad 8*g_cap)
    near_cnt: torch.Tensor
    win_first: torch.Tensor  # [T, win_cap_eff] aligned window starts (pad 0)
    win_mask: torch.Tensor   # [T, 4, win_cap_eff] 128-bit lane masks
    win_cnt: torch.Tensor    # [T] live window count
    ss_overflow: torch.Tensor
    sup_overflow: torch.Tensor
    mid_overflow: torch.Tensor
    cmid_overflow: torch.Tensor
    near_overflow: torch.Tensor


def _row_compact_one(key: torch.Tensor, big: int, cap: int):
    """Pack each row's keys < big ascending into (idx [C, cap], cnt [C]);
    absent lanes hold big."""
    skey = torch.sort(key, dim=1).values
    cnt = (key < big).sum(dim=1)
    if cap > skey.shape[1]:
        skey = torch.cat([skey, skey.new_full((skey.shape[0],
                                               cap - skey.shape[1]), big)], 1)
    lane = torch.arange(cap, device=key.device)[None, :]
    return torch.where(lane < cnt[:, None], skey[:, :cap], big), cnt


def _lowmask(k: torch.Tensor) -> torch.Tensor:
    """int32 with the low `k` bits set (k in [0, 32]); ``1 << 31`` wraps to
    INT32_MIN and minus one wraps on to 0x7FFFFFFF, as in int32 jnp."""
    one = torch.ones_like(k, dtype=_I32)
    shifted = (one << torch.clamp(k, 0, 31).to(_I32)) - 1
    return torch.where(k >= 32, torch.full_like(shifted, -1), shifted)


def _pieces(f: torch.Tensor, cnt: torch.Tensor, p: int, big: int):
    """P aligned pieces per run: piece j is window (f//128 + j)'s overlap
    with [f, f+cnt), as (window key [R, K*P], int32 lane-mask words
    [R, K*P, 4], word m covering lanes 32m..32m+31), run-major.  Dead
    pieces carry the run's last live window key with a zero mask, so for
    ascending disjoint runs the key sequence is non-decreasing; dead runs
    (cnt == 0) key `big`."""
    r, k = f.shape
    dev = f.device
    j = SPAN_ALIGN * torch.arange(p, device=dev)               # [P]
    w = (f // SPAN_ALIGN)[..., None]
    off = (f % SPAN_ALIGN)[..., None]
    cnt = cnt[..., None]
    end = off + cnt
    key_last = w + torch.clamp((end + SPAN_ALIGN - 1) // SPAN_ALIGN - 1, min=0)
    live = (cnt > 0) & (end > j)                                # [R, K, P]
    key = torch.where(live, w + j // SPAN_ALIGN,
                      torch.where(cnt > 0, key_last, big))
    s_j = torch.clamp(off - j, min=0)[..., None]
    e_j = torch.clamp(end - j, max=SPAN_ALIGN)[..., None]
    m = 32 * torch.arange(4, device=dev)
    words = torch.where(live[..., None],
                        _lowmask(e_j - m) & ~_lowmask(s_j - m),
                        torch.zeros((), dtype=_I32, device=dev))  # [R,K,P,4]
    return key.reshape(r, k * p), words.reshape(r, k * p, 4)


def _window_masks(first: torch.Tensor, count: torch.Tensor, win_cap: int,
                  pieces: int, with_demand: bool = False):
    """Near-child runs -> deduplicated (aligned window, 128-bit mask)
    pairs, capped at win_cap distinct windows per row.

    first, count: [R, K] runs in ascending disjoint order, live prefix
    (the order of the compacted near lists).  `pieces` is the number of
    windows one run can touch (cfg.win_pieces); it has no default, since
    too few pieces drop interior windows of long runs (missing mass).

    Returns (win_first [R, W] int32, win_mask [R, 4, W] int32, win_cnt
    [R], kept_children [R], dropped [R] bool), W = min(win_cap, pieces*K).
    Children whose windows pass win_cap form a suffix and are dropped
    WHOLLY: their pieces' masks are zeroed before the merge and the caller
    truncates their anti-rows (kept_children), so they keep their own
    child monopole.  With `with_demand` a sixth result: each row's
    distinct live windows [R], what win_cap would have to be to drop no
    child.  This one routine stands for both JAX variants (_window_masks
    and its dense oracle)."""
    big = _BIG
    dev = first.device
    p = pieces
    r, k = first.shape
    out_cap = min(win_cap, p * k)
    f, c = first.to(_I64), count.to(_I64)
    key, ms = _pieces(f, c, p, big)                   # [R, P*K], [R, P*K, 4]
    width = p * k
    bnd = torch.cat([torch.ones_like(key[:, :1], dtype=torch.bool),
                     key[:, 1:] != key[:, :-1]], dim=1)
    rank = torch.cumsum(bnd.to(_I64), dim=1) - 1          # window rank
    child_live = c > 0
    child_drop = child_live & (rank[:, p - 1::p] >= win_cap)
    kept = (child_live & ~child_drop).sum(dim=1)
    dropped = child_drop.any(dim=1)
    drop_pos = child_drop.repeat_interleave(p, dim=1)
    # segmented OR == segmented sum: merged pieces cover disjoint lanes
    words = torch.where(drop_pos[..., None], 0, ms.to(_I64) & 0xFFFFFFFF)
    flat = (rank + width * torch.arange(r, device=dev)[:, None]).reshape(-1)
    acc = torch.zeros((r * width, 4), dtype=_I64, device=dev)
    acc.index_add_(0, flat, words.reshape(-1, 4))
    seg_key = torch.full((r * width,), big, dtype=_I64, device=dev)
    seg_key.scatter_(0, flat, key.reshape(-1))            # equal per segment
    seg_key = seg_key.reshape(r, width)[:, :out_cap]
    acc = acc.reshape(r, width, 4)[:, :out_cap]
    live = seg_key < big
    win_first = torch.where(live, seg_key * SPAN_ALIGN, 0).to(_I32)
    acc = torch.where(live[..., None], acc, 0)
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)   # as int32
    win_mask = acc.permute(0, 2, 1).to(_I32).contiguous()
    out = (win_first, win_mask, live.sum(dim=1), kept, dropped)
    if with_demand:
        out += ((bnd & (key < big)).sum(dim=1),)
    return out


def cell_band_lists(tgt_subs: GroupInfo, ss: Supers, supers: Supers, cells,
                    cfg: SimConfig, skin=0.0, demand=None) -> CellBands:
    """The band classification (cell_band_lists_torch): the CUDA kernel
    of ``ops/cuda/classify.py`` when ``cfg.use_pallas`` is set (on CUDA
    tensors; bit for bit the plain version's, the demand too), the plain
    version otherwise."""
    fn = cell_band_lists_torch
    if cfg.use_pallas:
        from nbody_tpu_torch.ops.cuda import classify

        fn = classify.cell_band_lists
    return fn(tgt_subs, ss, supers, cells, cfg, skin=skin, demand=demand)


def cell_band_lists_torch(tgt_subs: GroupInfo, ss: Supers, supers: Supers,
                          cells, cfg: SimConfig, skin=0.0,
                          demand=None) -> CellBands:
    """Four-stage classification, chunked over target tiles.

    Stage 0 tests every super-super against the tile's sub-spheres (min
    gap); stage 1 the failing super-supers' member supers; stage 2 the
    failing supers' cells (mid); stage 3 the failing cells' children,
    each refined to its grandchild monopoles if those pass (cmid) or
    marked for exact P2P (near), whose runs become deduplicated windows.
    `skin` is a uniform margin for band reuse; per-entity skins compose
    with it: (diam + 2*(src_skin + skin/2)) /
    dist(max(gap - (src_skin + skin/2) - (tgt_skin + skin/2), 0)) < theta.
    `demand`, an int32 [6] tensor, receives the build's BAND_DEMAND: each
    list's raw count and the distinct near windows, the most over tiles
    (a list past its cap overflows: its flag is set and its entries past
    the cap are dropped; the counts downstream of it are then taken over
    the kept entries only).
    """
    dev = tgt_subs.center.device
    ss_cap, s_cap = cfg.ss_cap, cfg.sup_cap
    mid_cap, cmid_cap, near_cap = cfg.mid_cap, cfg.cmid_cap, cfg.near_cap
    theta = cfg.theta
    soft = soft_term(cfg)
    n_ss = ss.com.shape[0]
    n_sup = supers.com.shape[0]
    g_cap = cells.gmass.shape[0]
    k_cap = 8 * g_cap
    t = tgt_subs.center.shape[0] // SUB_FACTOR
    big = _BIG
    half = 0.5 * float(skin)
    f32 = torch.float32

    def zero_row(x):
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])

    # per-super fields grouped by super-super: [n_ss+1, 8, 6]
    # (com3, diam, skin, gmass), zero pad row
    supf = torch.cat([supers.com, supers.diam[:, None], supers.skin[:, None],
                      supers.gmass[:, None]], dim=1)
    if 8 * n_ss != n_sup:
        supf = torch.cat([supf, supf.new_zeros((8 * n_ss - n_sup, 6))])
    supf8 = zero_row(supf.reshape(n_ss, 8, 6))
    # per-cell fields grouped by super, gmass lane forced to 1 (empty
    # cells have diam 0 and never fail): [n_sup+1, 8, 6]
    cellf = torch.cat([cells.com, cells.diam[:, None], cells.skin[:, None]], 1)
    cellf8 = zero_row(cellf.reshape(n_sup, 8, 5))
    cellf6 = torch.cat([cellf8, torch.ones(cellf8.shape[:2] + (1,), dtype=f32,
                                           device=dev)], dim=-1)
    # per-child fields [g_cap+1, 8, 14]: com3, diam, gchild_diam_max,
    # grandchild-COM box lo3/hi3, gmass, skin, gchild_complete
    gc_ok = (cells.gchild_gmass > 0)[..., None]
    gc_lo = torch.where(gc_ok, cells.gchild_com, _BIG_F).amin(dim=2)
    gc_hi = torch.where(gc_ok, cells.gchild_com, -_BIG_F).amax(dim=2)
    kidf = zero_row(torch.cat(
        [cells.child_com, cells.child_diam[..., None],
         cells.gchild_diam_max[..., None], gc_lo, gc_hi,
         cells.child_gmass[..., None], cells.child_skin[..., None],
         cells.gchild_complete.to(f32)[..., None]], dim=-1))
    # per-child particle runs for the near windows: [8*g_cap+1, 2]
    fc_flat = zero_row(torch.stack([cells.child_first.reshape(-1),
                                    cells.child_count.reshape(-1)], dim=1))

    centers = tgt_subs.center.reshape(t, SUB_FACTOR, 3)
    radii = tgt_subs.radius.reshape(t, SUB_FACTOR)
    tskins = tgt_subs.skin.reshape(t, SUB_FACTOR)
    # same chunk bound as the JAX package: bounded per-chunk panels
    per_row = 24 * n_ss + 120 * ss_cap + 120 * s_cap + 250 * mid_cap
    chunk = max(8, min(256, (28 << 20) // max(per_row, 1)))
    ss_ids = torch.arange(n_ss, device=dev)[None, :]
    arange8 = torch.arange(8, device=dev)

    def one_chunk(ctr, rad, tsk):
        c_rows = ctr.shape[0]
        rad_t = rad + tsk + half                        # [C, 8]

        def sub_gap(com, src_skin):
            # com [C, K, 3], src_skin [C, K] -> deflated min gap [C, K]
            gap = _norm3(com[:, :, None, :] - ctr[:, None, :, :]) \
                - rad_t[:, None, :]
            gap = torch.clamp(gap.amin(dim=-1), min=0.0)
            return torch.clamp(gap - (src_skin + half), min=0.0)

        def gated_mac(idx_list, pack, n_rows, id_cap):
            """Failing members (8 per listed parent) of each row's listed
            parents, as keys (member id, big where passing); pad parents
            resolve to the zero row, whose members fail nothing."""
            ids = torch.clamp(idx_list, max=n_rows)
            f = pack[ids].reshape(c_rows, -1, 6)
            kid = (ids[:, :, None] * 8 + arange8).reshape(c_rows, -1)
            sk = f[..., 4] + half
            g = sub_gap(f[..., 0:3], f[..., 4])
            dist = torch.sqrt(g * g + soft)
            fail = (((f[..., 3] + 2.0 * sk) / dist >= theta)
                    & (f[..., 5] > 0) & (kid < id_cap))
            return torch.where(fail, kid, big)

        # stage 0: super-supers, the only dense panel over all sources
        gap = _norm3(ss.com[None, :, None, :] - ctr[:, None, :, :]) \
            - rad_t[:, None, :]
        sssk = ss.skin[None, :] + half
        gap = torch.clamp(torch.clamp(gap.amin(dim=-1), min=0.0) - sssk,
                          min=0.0)
        dist = torch.sqrt(gap * gap + soft)
        fail0 = (((ss.diam[None, :] + 2.0 * sssk) / dist >= theta)
                 & (ss.gmass > 0)[None, :])
        ss_idx, ss_cnt = _row_compact_one(torch.where(fail0, ss_ids, big),
                                          big, ss_cap)
        # stage 1: the failing super-supers' member supers
        sup_idx, sup_cnt = _row_compact_one(
            gated_mac(ss_idx, supf8, n_ss, 8 * n_ss), big, s_cap)
        # stage 2: the failing supers' cells
        mid_idx, mc_raw = _row_compact_one(
            gated_mac(sup_idx, cellf6, n_sup, g_cap), big, mid_cap)

        # stage 3: the failing cells' children
        midc = torch.clamp(mid_idx, max=g_cap)
        kf = kidf[midc].reshape(c_rows, -1, 14)
        kid_id = (midc[:, :, None] * 8 + arange8).reshape(c_rows, -1)
        ksk = kf[..., 12] + half
        g = sub_gap(kf[..., 0:3], kf[..., 12])
        distk = torch.sqrt(g * g + soft)
        live = (kf[..., 11] > 0) & (kid_id < k_cap)
        failk = ((kf[..., 3] + 2.0 * ksk) / distk >= theta) & live
        # gap to the grandchild-COM box (closest possible grandchild COM)
        cl = torch.minimum(torch.maximum(ctr[:, None, :, :],
                                         kf[:, :, None, 5:8]),
                           kf[:, :, None, 8:11])
        gap_box = _norm3(cl - ctr[:, None, :, :]) - rad_t[:, None, :]
        gap_box = torch.clamp(
            torch.clamp(gap_box.amin(dim=-1), min=0.0) - ksk, min=0.0)
        dist_box = torch.sqrt(gap_box * gap_box + soft)
        cmid_m = (failk & ((kf[..., 4] + 2.0 * ksk) / dist_box < theta)
                  & (kf[..., 13] > 0.5))
        near_m = failk & ~cmid_m
        ci, cc = _row_compact_one(torch.where(cmid_m, kid_id, big), big,
                                  cmid_cap)
        ni, nc = _row_compact_one(torch.where(near_m, kid_id, big), big,
                                  near_cap)

        # near windows; children past win_cap drop with their anti-rows
        ni_safe = torch.clamp(ni, max=k_cap)
        fc = fc_flat[ni_safe]                           # [C, near_cap, 2]
        wf, wm, win_cnt, kept, dropped, win_dem = _window_masks(
            fc[..., 0], fc[..., 1], cfg.win_cap_eff, cfg.win_pieces,
            with_demand=True)
        nc_k = torch.minimum(torch.clamp(nc, max=near_cap), kept)
        lane_n = torch.arange(near_cap, device=dev)[None, :]
        ni_safe = torch.where(lane_n < nc_k[:, None], ni_safe, k_cap)
        return (
            torch.clamp(ss_idx, max=n_ss), torch.clamp(ss_cnt, max=ss_cap),
            torch.clamp(sup_idx, max=n_sup), torch.clamp(sup_cnt, max=s_cap),
            torch.clamp(mid_idx, max=g_cap), torch.clamp(mc_raw, max=mid_cap),
            torch.clamp(ci, max=k_cap), torch.clamp(cc, max=cmid_cap),
            ni_safe, nc_k, wf, wm, win_cnt,
            (ss_cnt > ss_cap).any(), (sup_cnt > s_cap).any(),
            (mc_raw > mid_cap).any(), (cc > cmid_cap).any(),
            ((nc > near_cap) | dropped).any(),
            torch.stack([x.max() for x in (ss_cnt, sup_cnt, mc_raw, cc, nc,
                                            win_dem)]),
        )

    parts = [one_chunk(centers[i:i + chunk], radii[i:i + chunk],
                       tskins[i:i + chunk]) for i in range(0, t, chunk)]
    cols = list(zip(*parts))

    def cat_i32(j):
        return torch.cat(cols[j]).to(_I32)

    def any_of(j):
        return torch.stack(cols[j]).any()

    if demand is not None:
        demand.copy_(torch.stack(cols[18]).amax(dim=0))
    return CellBands(
        ss_idx=cat_i32(0), ss_cnt=cat_i32(1),
        sup_idx=cat_i32(2), sup_cnt=cat_i32(3),
        mid_idx=cat_i32(4), mid_cnt=cat_i32(5),
        cmid_idx=cat_i32(6), cmid_cnt=cat_i32(7),
        near_idx=cat_i32(8), near_cnt=cat_i32(9),
        win_first=cat_i32(10), win_mask=cat_i32(11), win_cnt=cat_i32(12),
        ss_overflow=any_of(13), sup_overflow=any_of(14),
        mid_overflow=any_of(15), cmid_overflow=any_of(16),
        near_overflow=any_of(17),
    )


# ---------------------------------------------------------------------------
# Per-tile tables
# ---------------------------------------------------------------------------


class TableSet(NamedTuple):
    """Per-tile band tables, planar [T, R] with R = near_cap +
    9*(ss_cap+sup_cap+mid_cap+cmid_cap): [near anti rows (live prefix
    near_cnt) | packed 9-row monopole items (live up to row_cnt)].  Only
    the live ranges [0, near_cnt) and [near_cap, row_cnt) of a row are
    specified: the CUDA build writes nothing else (the plain one writes
    zeros there), and no sweep reads anything else."""

    tx: torch.Tensor        # [T, R] source x
    ty: torch.Tensor        # [T, R] source y
    tz: torch.Tensor        # [T, R] source z
    tm: torch.Tensor        # [T, R] G * mass (negated on anti rows)
    row_cnt: torch.Tensor   # [T] int32 near_cap + 9 * items
    near_cnt: torch.Tensor  # [T] int32 live near anti rows


def live_rows(near_cnt: torch.Tensor, row_cnt: torch.Tensor, near_cap: int,
              width: int) -> torch.Tensor:
    """[T, width] bool: the rows of each tile's table that a sweep reads,
    [0, near_cnt) and [near_cap, row_cnt)."""
    lane = torch.arange(width, device=near_cnt.device)
    return torch.where(lane < near_cap, lane < near_cnt[:, None],
                       lane < row_cnt[:, None])


def build_cell_tables(cells, supers: Supers, ss: Supers, bands: CellBands,
                      cfg: SimConfig) -> TableSet:
    """The per-tile tables (build_cell_tables_torch): the CUDA kernel of
    ``ops/cuda/tables.py`` when ``cfg.use_pallas`` is set (on CUDA
    tensors; the live rows and counts bit for bit the plain version's,
    no other row written), the plain version otherwise."""
    fn = build_cell_tables_torch
    if cfg.use_pallas:
        from nbody_tpu_torch.ops.cuda import tables as kern_tables

        fn = kern_tables.build_cell_tables
    return fn(cells, supers, ss, bands)


def build_cell_tables_torch(cells, supers: Supers, ss: Supers,
                            bands: CellBands) -> TableSet:
    """Gather each tile's table rows [x, y, z, G*m]: a negated row per
    NEAR child (its exact P2P comes from the near sweep), and a 9-row
    item per failing super-super / super / cell / cmid child (its 8
    member monopoles plus itself negated, cancelling the coarser level's
    term).  Items are packed to the front; pad ids resolve to zero rows."""
    dev = cells.gmass.device
    g_cap = cells.gmass.shape[0]
    k_cap = 8 * g_cap
    n_sup = supers.com.shape[0]
    n_ss = ss.com.shape[0]
    t = bands.sup_idx.shape[0]
    big = torch.iinfo(torch.int32).max

    def zero_row(x):
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])

    def item(members, parent_com, parent_gm):
        anti = torch.cat([parent_com, -parent_gm[:, None]], dim=1)[:, None, :]
        return zero_row(torch.cat([members, anti], dim=1).reshape(-1, 36))

    sup4 = torch.cat([supers.com, supers.gmass[:, None]], dim=1)
    if 8 * n_ss != n_sup:
        sup4 = torch.cat([sup4, sup4.new_zeros((8 * n_ss - n_sup, 4))])
    cell4 = torch.cat([cells.com, cells.gmass[:, None]], dim=1)
    child4 = torch.cat([cells.child_com, cells.child_gmass[..., None]], dim=-1)
    gc4 = torch.cat([cells.gchild_com, cells.gchild_gmass[..., None]],
                    dim=-1).reshape(k_cap, 8, 4)
    anti_child = torch.cat([child4[..., 0:3], -child4[..., 3:4]],
                           dim=-1).reshape(k_cap, 4)
    ext_all = torch.cat([
        item(sup4.reshape(n_ss, 8, 4), ss.com, ss.gmass),
        item(cell4.reshape(n_sup, 8, 4), supers.com, supers.gmass),
        item(child4, cells.com, cells.gmass),
        item(gc4, child4.reshape(k_cap, 4)[:, 0:3], child4.reshape(k_cap, 4)[:, 3]),
    ])
    off_a = n_ss + 1
    off_b = off_a + n_sup + 1
    off_c = off_b + g_cap + 1
    lists = [(bands.ss_idx, n_ss, 0, bands.ss_cnt),
             (bands.sup_idx, n_sup, off_a, bands.sup_cnt),
             (bands.mid_idx, g_cap, off_b, bands.mid_cnt),
             (bands.cmid_idx, k_cap, off_c, bands.cmid_cnt)]
    items = torch.cat([torch.clamp(ix.to(_I64), max=cap) + off
                       for ix, cap, off, _ in lists], dim=1)       # [T, K]
    valid = torch.cat([torch.arange(ix.shape[1], device=dev)[None, :]
                       < cnt[:, None] for ix, _, _, cnt in lists], dim=1)
    k_items = items.shape[1]
    lane = torch.arange(k_items, device=dev)[None, :]
    order = torch.sort(torch.where(valid, lane, big), dim=1, stable=True).indices
    items = items.gather(1, order)                  # live items first
    antiN = zero_row(anti_child)
    near_cap = bands.near_idx.shape[1]
    ni_safe = torch.clamp(bands.near_idx.to(_I64), max=k_cap)
    n_items = (bands.ss_cnt + bands.sup_cnt + bands.mid_cnt
               + bands.cmid_cnt).to(_I64)
    near_cnt = bands.near_cnt.to(_I64)

    # every row at the caps' width: pad ids gather zero rows
    planes = torch.empty((4, t, near_cap + 9 * k_items), dtype=torch.float32,
                         device=dev)
    tc = 256
    for r0 in range(0, t, tc):
        r1 = min(r0 + tc, t)
        g = ext_all[items[r0:r1]].reshape(r1 - r0, 9 * k_items, 4)
        planes[:, r0:r1, near_cap:] = g.permute(2, 0, 1)
        planes[:, r0:r1, :near_cap] = antiN[ni_safe[r0:r1]].permute(2, 0, 1)
    row_cnt = near_cap + 9 * n_items
    return TableSet(tx=planes[0], ty=planes[1], tz=planes[2], tm=planes[3],
                    row_cnt=row_cnt.to(_I32), near_cnt=near_cnt.to(_I32))


# ---------------------------------------------------------------------------
# Plain versions of the three sweeps (the CUDA kernels' reference)
# ---------------------------------------------------------------------------


def _tile_panel(pb, qx, qy, qz, qm, soft):
    """[C, B, 3] targets against per-tile [C, S] planar sources."""
    dx = qx[:, None, :] - pb[:, :, 0:1]
    dy = qy[:, None, :] - pb[:, :, 1:2]
    dz = qz[:, None, :] - pb[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    inv = 1.0 / torch.sqrt(d2 + soft)
    w = qm[:, None, :] * (inv * inv * inv)
    return _sum_terms(w, dx, dy, dz)


def far_sweep_torch(pos_s: torch.Tensor, supers: Supers,
                    cfg: SimConfig) -> torch.Tensor:
    """Every target against every top-level monopole (gmass carries G;
    pad rows have zero mass and add nothing)."""
    soft = soft_term(cfg)
    s = max(supers.gmass.shape[0], 1)
    blk = max(1, _PANEL_ELEMS // s)
    return torch.cat([_panel_accel(pos_s[i:i + blk], supers.com, supers.gmass,
                                   1.0, soft)
                      for i in range(0, pos_s.shape[0], blk)])


def table_sweep_torch(tgt_pos: torch.Tensor, tables: TableSet,
                      cfg: SimConfig) -> torch.Tensor:
    """Each tile's targets against its table row up to the longest live
    row, every row outside the tile's live ranges [0, near_cnt) and
    [near_cap, row_cnt) read as zero whatever it holds (TableSet)."""
    b = cfg.force_tile
    soft = soft_term(cfg)
    t = tgt_pos.shape[0] // b
    rows = max(int(tables.row_cnt.max()), 1)
    pb = tgt_pos.reshape(t, b, 3)
    tc = max(1, _PANEL_ELEMS // (b * rows))
    width = tables.tx[:, :rows].shape[1]

    def panel(i):
        live = live_rows(tables.near_cnt[i:i + tc], tables.row_cnt[i:i + tc],
                         cfg.near_cap, width)
        q = [torch.where(live, p[i:i + tc, :rows], 0.0) for p in tables[:4]]
        return _tile_panel(pb[i:i + tc], *q, soft)

    return torch.cat([panel(i) for i in range(0, t, tc)]).reshape(-1, 3)


def near_correction_torch(tgt_pos: torch.Tensor, src_pos: torch.Tensor,
                          src_mass: torch.Tensor, win_first: torch.Tensor,
                          win_mask: torch.Tensor, win_cnt: torch.Tensor,
                          cfg: SimConfig) -> torch.Tensor:
    """Exact P2P of each tile against its first win_cnt windows: window k
    is the 128 sorted sources from win_first[t, k], lane l taken iff bit
    l%32 of win_mask[t, l//32, k] is set (lanes past the sources count as
    massless)."""
    b = cfg.force_tile
    soft = soft_term(cfg)
    n_src = src_pos.shape[0]
    t = tgt_pos.shape[0] // b
    dev = tgt_pos.device
    w = max(int(win_cnt.max()), 1)
    lane = torch.arange(SPAN_ALIGN, device=dev)
    pb = tgt_pos.reshape(t, b, 3)
    tc = max(1, _PANEL_ELEMS // (b * w * SPAN_ALIGN))
    out = []
    for i in range(0, t, tc):
        f = win_first[i:i + tc, :w].to(_I64)                  # [C, W]
        m = win_mask[i:i + tc, :, :w]                         # [C, 4, W]
        live = torch.arange(w, device=dev)[None, :] < win_cnt[i:i + tc, None]
        pick = f[:, :, None] + lane                           # [C, W, 128]
        word = m[:, lane // 32, :].permute(0, 2, 1)           # [C, W, 128]
        ok = (((word >> (lane % 32)) & 1) == 1) & live[..., None] \
            & (pick < n_src)
        pick = torch.clamp(pick, max=n_src - 1).reshape(pick.shape[0], -1)
        q = src_pos[pick]                                     # [C, W*128, 3]
        qm = torch.where(ok.reshape(pick.shape), cfg.g * src_mass[pick], 0.0)
        out.append(_tile_panel(pb[i:i + tc], q[..., 0], q[..., 1], q[..., 2],
                               qm, soft))
    return torch.cat(out).reshape(-1, 3)


# ---------------------------------------------------------------------------
# The production path and its dispatch
# ---------------------------------------------------------------------------


def build_bands(pos_s: torch.Tensor, mass_s: torch.Tensor,
                codes_s: torch.Tensor, cfg: SimConfig, skin=0.0,
                drift: torch.Tensor | None = None,
                demand: torch.Tensor | None = None):
    """Adaptive cells -> supers -> super-supers -> tile sub-spheres ->
    band lists -> tables, on Morton-sorted tile-padded inputs.  Returns
    (cells, far, bands, tables), `far` being the super-supers the far
    sweep runs over; `demand` (int32 [6], zeroed) receives the band
    lists' BAND_DEMAND (cell_band_lists)."""
    b = cfg.force_tile
    bits = cfg.morton_bits
    box_lo, box_size = _bbox.bounding_cube(pos_s)
    cells = build_source_cells(
        codes_s, pos_s, mass_s, b, cfg.g, cfg.cell_capacity, box_lo, box_size,
        drift_sorted=drift, g2_factor=cfg.g2_cap_factor, bits=bits,
    )
    supers = make_supers(cells)
    ss = make_ss(supers, cfg)
    tgt_subs = target_subspheres(pos_s, b, drift=drift, codes=codes_s,
                                 bits=bits)
    bands = cell_band_lists(tgt_subs, ss, supers, cells, cfg, skin=skin,
                            demand=demand)
    tables = build_cell_tables(cells, supers, ss, bands, cfg)
    return cells, ss, bands, tables


def apply_farmid(pos_s: torch.Tensor, supers: Supers, tables: TableSet,
                 cfg: SimConfig) -> torch.Tensor:
    """The smooth component: far sweep + table sweep."""
    if cfg.use_pallas:
        from nbody_tpu_torch.ops.cuda import forces as kern

        return kern.far_sweep(pos_s, supers, cfg) + kern.table_sweep(
            pos_s, tables, cfg)
    return far_sweep_torch(pos_s, supers, cfg) + table_sweep_torch(
        pos_s, tables, cfg)


def apply_near(pos_s: torch.Tensor, src_pos: torch.Tensor,
               src_mass: torch.Tensor, bands: CellBands,
               cfg: SimConfig) -> torch.Tensor:
    """The exact P2P near band."""
    fn = near_correction_torch
    if cfg.use_pallas:
        from nbody_tpu_torch.ops.cuda import forces as kern

        fn = kern.near_span
    return fn(pos_s, src_pos, src_mass, bands.win_first, bands.win_mask,
              bands.win_cnt, cfg)


def refresh_farmid(pos_live: torch.Tensor, mass_s: torch.Tensor,
                   codes_s: torch.Tensor, drift: torch.Tensor,
                   box_lo: torch.Tensor, box_size: torch.Tensor,
                   bands: CellBands, cfg: SimConfig,
                   tgt_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Far+mid at a FROZEN cut with every source moment recomputed from
    live positions: the frozen codes give the same segments, the frozen
    classification is regathered into fresh tables, and the smooth
    component is evaluated at `tgt_pos` (default: the live positions).
    The skins that keep the frozen classification conservative cover the
    members' drift from the frozen analytic cell geometry."""
    cells_r = build_source_cells(
        codes_s, pos_live, mass_s, cfg.force_tile, cfg.g, cfg.cell_capacity,
        box_lo, box_size, drift_sorted=drift, g2_factor=cfg.g2_cap_factor,
        bits=cfg.morton_bits,
    )
    supers_r = make_supers(cells_r)
    ss_r = make_ss(supers_r, cfg)
    tables_r = build_cell_tables(cells_r, supers_r, ss_r, bands, cfg)
    return apply_farmid(pos_live if tgt_pos is None else tgt_pos, ss_r,
                        tables_r, cfg)


def apply_bands(pos_s, mass_s, supers: Supers, bands: CellBands,
                tables: TableSet, cfg: SimConfig, src_pos=None, src_mass=None):
    """Evaluate the three bands (sources default to the targets)."""
    if src_pos is None:
        src_pos, src_mass = pos_s, mass_s
    return apply_farmid(pos_s, supers, tables, cfg) + apply_near(
        pos_s, src_pos, src_mass, bands, cfg)


def bh_forces_grouped(pos_s: torch.Tensor, mass_s: torch.Tensor,
                      codes_s: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Production Barnes-Hut forces on Morton-sorted tile-padded arrays:
    every monopole-approximated region satisfies width/dist < theta for
    every target of its tile; the rest is exact."""
    _, ss, bands, tables = build_bands(pos_s, mass_s, codes_s, cfg)
    return apply_bands(pos_s, mass_s, ss, bands, tables, cfg)
