"""Multi-device Barnes-Hut over a 1-D mesh of ranks (torch.distributed):
the port of nbody_tpu/parallel/shard.py, which runs the same physics
under shard_map on a TPU slice (BASELINE config 5: N = 4M on 8 chips).

SPMD: every rank calls the same function on its own slab, and the
collectives are those of parallel/comm.py.  The decomposition is the
JAX package's (see its module docstring for the design):

  * particles live in Morton-sorted slabs: rank d owns rows
    [d*N/D, (d+1)*N/D) of the global sorted order, and the slabs stay
    resident across rebuilds;
  * per rebuild, one all_gather of (pos, mass, |v|, |a|) (24 B a
    particle); every rank derives the same global Morton permutation
    (a stable sort of identical inputs) and re-slabs its own velocity,
    acceleration, id (and held far+mid) rows through a neighbour halo
    exchange (`_reslab`), with a full gather when a slab moved past the
    halo; the adaptive cells are built owner-computes over slab + 4b
    halo windows (ops/cells.build_source_cells_window) and stitched into
    the replicated global cell list by an O(cells) summary all_gather
    (`_stitch_cells`); classification and tables cover only the rank's
    own T/D target tiles;
  * per step, a fixed 2h-row position halo (`_halo_ext`) plus a fixed
    all_to_all of the out-of-halo near windows (`_near_fetch_plan`,
    `_fetch_windows`) feed the exact near band, with the live-position
    all_gather as the fallback; far+mid read the replicated monopoles and
    the rank's own tables; integration is slab-local.

Where JAX selects a path with ``lax.cond`` on a replicated predicate,
this module decides on the host: every rebuild sums the ranks' counts of
out-of-halo rows, over-cap fetch lists and band overflows in ONE
all-reduce and reads them, with the validity horizon, in ONE host read.
The frozen choices (near path, fetch requests) hold for the cycle, so an
inner step reads nothing back.

Entry points (each takes this rank's `Mesh`): `make_sharded_step`,
`make_sharded_runner` (fixed-K cycles), `make_sharded_adaptive_runner`
(the production path; `sharded_4m` routes here through `run_sharded`),
`run_sharded` and `shard_state`.  The runners take this rank's slab of a
state in the original order (`shard_state`) and return the full state
in the original order on every rank, as JAX's jitted wrappers return one
global array.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Optional, Tuple

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.ops import bbox, forces, integrate as integ
from nbody_tpu_torch.ops.cells import (
    SourceCells, build_source_cells_window, last_bmax_boundary,
)
from nbody_tpu_torch.models.simulation import (
    _AdaptiveLoop, _norms, _pad_cycle_state, _unpad, adaptive_drift,
    bands_overflowed, drift_bound, hold_predict_pos, k_next_of,
    sort_by_morton, validity_horizon,
)
from nbody_tpu_torch.parallel import comm
from nbody_tpu_torch.parallel.comm import (
    Mesh, all_gather, axis_index, axis_size,
)

_I64 = torch.int64


def _check_mesh(cfg: SimConfig, mesh: Mesh) -> None:
    """A config that names its slab count (cfg.mesh_shape, e.g.
    sharded_4m's (8,)) runs on a mesh of that many ranks."""
    if cfg.mesh_shape and math.prod(cfg.mesh_shape) != mesh.size:
        raise ValueError(f"cfg.mesh_shape {cfg.mesh_shape} needs "
                         f"{math.prod(cfg.mesh_shape)} ranks, the mesh has "
                         f"{mesh.size}")


_SHARD_CELL_SKEW = 4   # per-shard owned-cell headroom over perfect balance


def _shard_cell_cap(cfg: SimConfig, d: int) -> int:
    """Per-shard OWNED-cell capacity for the windowed build:
    cell_capacity/D with _SHARD_CELL_SKEW headroom (the contracted core
    concentrates small cells in a few slabs), rounded up to 64, never
    above the global cap.  Per-shard overflow is summed into the global
    cells.overflow, so a skew bust is as loud as a global cap bust."""
    cap = -(-cfg.cell_capacity * _SHARD_CELL_SKEW // (64 * d)) * 64
    return min(cfg.cell_capacity, max(64, cap))


_ROW_FIELDS = tuple(f for f in SourceCells._fields
                    if f not in ("n_cells", "n_child", "n_g2", "overflow",
                                 "overflow_g2"))


def _stitch_cells(sc: SourceCells, g_cap: int, cap_s: int,
                  mesh: Mesh) -> SourceCells:
    """all_gather the per-shard OWNED cell rows (packed live prefixes)
    and compact them into the global SourceCells every rank needs for
    the far/mid sweeps and classification.

    Shards' cells concatenated in shard order ARE the global cell list,
    so global row r takes row r - off[i] of the last shard i whose block
    starts at or before r (off: exclusive prefix of the shards' counts),
    if that row is inside the shard's capacity, else the pad value
    (zeros; +/-big for lo/hi; False for gchild_complete): the same rows
    as JAX's D ascending block writes.  The rows travel in one all_gather
    per dtype (~1.5 KB a cell), not O(N) positions."""
    dev = sc.count.device
    n_i = all_gather(sc.n_cells.reshape(1), mesh)                 # [D]
    off = torch.cumsum(n_i, 0) - n_i
    n_tot = n_i.sum()
    r = torch.arange(g_cap, device=dev)
    src = torch.searchsorted(off, r, right=True) - 1
    loc = r - off[src]
    hit = loc < cap_s
    rows = src * cap_s + torch.clamp(loc, max=cap_s - 1)

    stitched = {}
    for dtype in (torch.float32, _I64, torch.bool):
        names = [f for f in _ROW_FIELDS if getattr(sc, f).dtype == dtype]
        flat = torch.cat([getattr(sc, f).reshape(cap_s, -1) for f in names], 1)
        g = all_gather(flat, mesh)[rows]                         # [g_cap, K]
        col = 0
        for f in names:
            x = getattr(sc, f)
            k = x[0].numel()
            v = g[:, col:col + k].reshape((g_cap,) + tuple(x.shape[1:]))
            col += k
            pad = {"lo": 3.0e38, "hi": -3.0e38}.get(f, False if dtype
                                                     == torch.bool else 0)
            hit_v = hit.view((-1,) + (1,) * (v.dim() - 1))
            stitched[f] = torch.where(hit_v, v, pad)
    sums = comm.psum(torch.stack([sc.overflow.to(_I64),
                                  sc.overflow_g2.to(_I64),
                                  sc.n_child, sc.n_g2]), mesh)
    return SourceCells(
        **stitched,
        n_cells=torch.clamp(n_tot, max=g_cap),
        n_child=sums[2],
        n_g2=sums[3],
        overflow=(sums[0] > 0) | (n_tot > g_cap),
        overflow_g2=sums[1] > 0,
    )


def _cells_sharded(codes_s, pos_s, mass_s, cfg: SimConfig, box_lo, box_size,
                   mesh: Mesh, drift=None):
    """OWNER-COMPUTES global SourceCells from the sorted global arrays:
    the windowed build of this rank's slab (O(N/D) compute) and the
    O(cells) stitch.  `box_lo`/`box_size` are passed in (not derived
    from pos_s) so a moment refresh at a FROZEN cut rebuilds moments
    from live positions against the rebuild-time quantization box.
    Returns (cells, codes_own)."""
    d, me = axis_size(mesh), axis_index(mesh)
    n_pad = pos_s.shape[0]
    m = n_pad // d                        # slab particles
    b = cfg.force_tile
    halo = 4 * b
    cap_s = _shard_cell_cap(cfg, d)
    start = me * m
    # slab + 4b halo window, edge-padded past the array's ends (never
    # clamped inward, so it stays centred on the owned rows)
    win_rows = torch.clamp(torch.arange(start - halo, start + m + halo,
                                        device=pos_s.device), 0, n_pad - 1)

    # cross-shard cut carry: the last max-depth run boundary BEFORE my slab
    codes_own = codes_s[start:start + m]
    my_last = last_bmax_boundary(codes_own, codes_s[max(start - 1, 0)],
                                 start, cfg.morton_bits)
    lasts = all_gather(my_last.reshape(1), mesh)                   # [D]
    earlier = torch.arange(d, device=lasts.device) < me
    carry = torch.where(earlier, lasts, -1).max()

    shard_cells = build_source_cells_window(
        codes_s[win_rows], pos_s[win_rows], mass_s[win_rows], b, cfg.g,
        cap_s, start, m, n_pad, carry, box_lo, box_size,
        drift_sorted=None if drift is None else drift[win_rows],
        g2_factor=cfg.g2_cap_factor, bits=cfg.morton_bits,
    )
    # config-5 invariant: per-rank cell-build output is OWNED cells only
    # (capacity cell_capacity*skew/D), never the global list
    assert shard_cells.first.shape[0] == cap_s
    return (_stitch_cells(shard_cells, cfg.cell_capacity, cap_s, mesh),
            codes_own)


def _classify_slab(pos_s, mass_s, codes_s, cfg: SimConfig, mesh: Mesh,
                   drift=None):
    """OWNER-COMPUTES cells + MY SLAB's classification.

    pos_s/mass_s/codes_s/drift are the GLOBAL sorted (padded) arrays;
    returns (cells, supers, bands_slab, tables_slab, my_pos), `supers`
    being the super-supers the far sweep runs over (build_bands'
    contract).  Per-rank classification work is statically T/D
    (asserted below)."""
    m = pos_s.shape[0] // axis_size(mesh)
    b = cfg.force_tile
    start = axis_index(mesh) * m

    box_lo, box_size = bbox.bounding_cube(pos_s)
    cells, codes_own = _cells_sharded(codes_s, pos_s, mass_s, cfg, box_lo,
                                      box_size, mesh, drift=drift)
    supers = forces.make_supers(cells)
    ss = forces.make_ss(supers, cfg)

    my_pos = pos_s[start:start + m]
    my_drift = None if drift is None else drift[start:start + m]
    tgt_subs = forces.target_subspheres(my_pos, b, drift=my_drift,
                                        codes=codes_own, bits=cfg.morton_bits)
    bands = forces.cell_band_lists(tgt_subs, ss, supers, cells, cfg)
    tables = forces.build_cell_tables(cells, supers, ss, bands, cfg)
    # config-5 invariant: classification output is the LOCAL slab only
    assert bands.sup_idx.shape[0] == m // b, (
        "per-rank classification must cover exactly T/D target blocks")
    assert tables.tx.shape[0] == m // b
    return cells, ss, bands, tables, my_pos


def _near_halo_rows(m: int, cfg: SimConfig) -> int:
    """Static halo width (rows) for the per-step near-band exchange:
    m // cfg.near_halo_div, at least one span, rounded UP to a span
    multiple so rebased window starts stay 128-aligned, capped at the
    slab size."""
    h = max(forces.SPAN_ALIGN, m // max(1, cfg.near_halo_div))
    h = -(-h // forces.SPAN_ALIGN) * forces.SPAN_ALIGN
    return min(h, m)


def _halo_ext(x: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """[m, ...] slab rows -> [m + 2h, ...] extended with the left
    neighbour's last h rows and the right neighbour's first h rows (one
    ring exchange).  The ring's wrap-around rows at the global ends are
    never addressed: global row i maps to ext row i - (me*m - h), and
    rank 0's windows have i >= 0 while the last rank's end at i < N."""
    left, right = comm.ppermute_ring(x[x.shape[0] - h:], x[:h], mesh)
    return torch.cat([left, x, right])


def _live_windows(bands) -> torch.Tensor:
    lane = torch.arange(bands.win_first.shape[1],
                        device=bands.win_first.device)[None, :]
    return lane < bands.win_cnt[:, None]


def _in_halo(wf: torch.Tensor, m: int, h: int, me: int) -> torch.Tensor:
    return (wf >= me * m - h) & (wf + forces.SPAN_ALIGN <= (me + 1) * m + h)


def _near_reach_ok(bands, m: int, h: int, mesh: Mesh) -> torch.Tensor:
    """Replicated device bool: every rank's live near windows lie inside
    its [me*m - h, (me+1)*m + h) halo extent (the halo-only near path
    would serve every rank)."""
    out = _live_windows(bands) & ~_in_halo(bands.win_first, m, h,
                                          axis_index(mesh))
    return comm.psum(out.sum().reshape(1), mesh)[0] == 0


_I32_INF = torch.iinfo(torch.int32).max


def _near_fetch_plan(bands, m: int, h: int, cfg: SimConfig, mesh: Mesh):
    """Per-cycle (frozen) plan for the window-granular near exchange.

    The disk galaxy's dense core sits at the seam of all eight top-level
    Morton octants, so core targets' near windows reference rank-DISTANT
    rows that no contiguous halo covers.  Each rank lists the DISTINCT
    out-of-halo SPAN_ALIGN-row windows its frozen bands reference and
    fetches exactly those rows per step by a fixed-size all_to_all
    (_fetch_windows).

    Returns (n_far, starts_srv, wf_remap):
      n_far     — this rank's distinct out-of-halo windows (with a cap of
                  0: its live out-of-halo windows, 0 iff none); the plan
                  holds iff no rank's n_far exceeds cfg.near_fetch_cap
                  (the rebuild sums that test with its other counts);
      starts_srv— [F] my sorted distinct out-of-halo window starts
                  (global sorted rows; unused slots point at my own slab
                  so served rows are always in range), or None when the
                  cap is 0 (halo-only mode);
      wf_remap  — [T_loc, win_cap] win_first rebased into the per-step
                  source array cat([halo_ext(p), fetched windows]):
                  in-halo windows -> wf - (me*m - h), fetched windows ->
                  m + 2h + SPAN_ALIGN * slot.
    """
    me = axis_index(mesh)
    live = _live_windows(bands)
    wf = bands.win_first
    in_halo = _in_halo(wf, m, h, me)
    remap_halo = torch.clamp(wf - (me * m - h), min=0)
    f_cap = cfg.near_fetch_cap
    if f_cap == 0:
        return (live & ~in_halo).sum(), None, remap_halo

    # distinct out-of-halo starts, ascending, first f_cap kept
    flat = torch.where(live & ~in_halo, wf, _I32_INF).reshape(-1)
    s = torch.sort(flat).values
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device),
                      s[1:] != s[:-1]]) & (s != _I32_INF)
    pos = torch.cumsum(uniq.to(_I64), 0) - 1
    idx = torch.where(uniq & (pos < f_cap), pos, f_cap)    # overflow -> slot F
    starts = s.new_full((f_cap + 1,), _I32_INF).scatter_(
        0, idx, torch.where(uniq, s, _I32_INF))[:f_cap]
    # out-of-halo windows -> the fetch region (exact whenever the plan
    # holds; clipped garbage otherwise, unused because the fallback runs)
    fi = torch.clamp(torch.searchsorted(starts, wf), 0, f_cap - 1)
    remap = torch.where(in_halo | ~live, remap_halo,
                        (m + 2 * h + forces.SPAN_ALIGN * fi).to(wf.dtype))
    # unused request slots point at my own slab (always-valid rows)
    starts_srv = torch.where(starts == _I32_INF, me * m, starts)
    return uniq.sum(), starts_srv, remap


def _fetch_windows(x: torch.Tensor, reqs_g: torch.Tensor, m: int,
                   mesh: Mesh) -> torch.Tensor:
    """Serve + fetch one round of window rows: `reqs_g` [D, F] holds every
    rank's requested window starts (global sorted rows, SPAN_ALIGN-
    aligned).  Each rank extracts, for every (peer, slot), the overlap of
    the requested 128-row window with its own slab (zeros elsewhere),
    one all_to_all routes block i to rank i, and the contributions are
    summed (each global row has exactly one owner).  Returns
    [F * SPAN_ALIGN, ...]: the rows of MY requested windows.  Wire cost:
    D * F * SPAN_ALIGN rows each way, independent of N."""
    span = forces.SPAN_ALIGN
    rows = reqs_g[:, :, None].to(_I64) + torch.arange(span, device=x.device)
    loc = rows - axis_index(mesh) * m
    valid = (loc >= 0) & (loc < m)
    g = x[torch.clamp(loc, 0, m - 1)]                         # [D, F, S, ...]
    mask = valid if x.dim() == 1 else valid[..., None]
    g = torch.where(mask, g, torch.zeros((), dtype=x.dtype, device=x.device))
    recv = comm.all_to_all(g.reshape((-1,) + tuple(x.shape[1:])), mesh)
    recv = recv.reshape((axis_size(mesh), -1) + tuple(x.shape[1:]))
    return recv.sum(dim=0)


class _ReslabPlan(NamedTuple):
    need: torch.Tensor     # [m] old global rows of my new slab
    off: torch.Tensor      # [m] their rows in the halo-extended old slab
    n_out: torch.Tensor    # [] how many of them lie outside it (this rank)


def _reslab_plan(perm: torch.Tensor, m: int, h: int,
                 mesh: Mesh) -> _ReslabPlan:
    """Where my new slab's rows (perm[me*m:(me+1)*m], rows of the OLD
    global sorted order) sit: the halo path serves them iff every rank's
    n_out is 0 (the rebuild sums it with its other counts)."""
    start = axis_index(mesh) * m
    need = perm[start:start + m]
    off = need - (start - h)
    return _ReslabPlan(need, off, ((off < 0) | (off >= m + 2 * h)).sum())


def _reslab(arrs, plan: _ReslabPlan, any_out: bool, h: int, mesh: Mesh):
    """Re-slab the slab-resident `arrs` (each [m, ...] rows of the OLD
    global sorted order) into the NEW order: rows plan.need of each.
    Fast path (fixed traffic): the 2h-row neighbour halo, then a local
    gather; `any_out` (replicated: some rank's rows moved past the halo)
    selects the full-gather fallback, so correctness never depends on the
    halo size."""
    if any_out:
        return tuple(all_gather(x, mesh)[plan.need] for x in arrs)
    m = arrs[0].shape[0]
    off = torch.clamp(plan.off, 0, m + 2 * h - 1)
    return tuple(_halo_ext(x, h, mesh)[off] for x in arrs)


class _Glob(NamedTuple):
    """The per-cycle near-exchange context, frozen at a rebuild."""

    mass_s: torch.Tensor                # replicated sorted masses (fallback)
    mass_src: Optional[torch.Tensor]    # the halo (+ fetched) masses
    near_fast: bool                     # the halo (+ fetch) path serves
    reqs_g: Optional[torch.Tensor]      # [D, F] every rank's window requests
    wf_remap: torch.Tensor              # win_first rebased into the sources


class _Rebuilt(NamedTuple):
    slab: tuple                 # (pos, vel, mass, acc, orig) of MY slab
    built: tuple                # (cells, supers, bands, tables, rctx)
    glob: _Glob
    s_valid: int                # validity horizon (k when not adaptive)
    k_next: torch.Tensor        # next envelope horizon (device scalar)
    afm: Optional[torch.Tensor]  # the re-slabbed held far+mid, or None
    paths: Tuple[str, str]      # (near path, reslab path) taken
    sums: Tuple[int, int, int]  # the ranks' summed counts: rows outside
                                # the reslab halo, ranks over the fetch
                                # cap, ranks whose bands overflowed


def _rebuild_sharded(pos, vel, mass, acc, orig, cfg: SimConfig, k: int,
                     adaptive: bool, mesh: Mesh, k_env=None,
                     afm=None) -> _Rebuilt:
    """One sharded band rebuild.  Inputs are slab rows of the current
    global sorted order; returns the re-slabbed state (new sorted order),
    the frozen band structures for MY slab, the per-cycle near-exchange
    context, the validity horizon (adaptive; `k_env` sizes this rebuild's
    skins) or k, the next envelope horizon, the re-slabbed held far+mid
    (`afm`: None in, None out) and the frozen refresh context rctx =
    (global sorted codes, drift bounds, box lo, box size) that
    _refresh_farmid_slab needs when cfg.refresh_moments (else None).

    Wire traffic: one all_gather of (pos, mass, |v|, |a|) (24 B a
    particle), never the full state, plus the fixed 2h-row halo exchange
    of (vel, acc, orig[, afm]) in `_reslab`.  Host reads: one."""
    d, me = axis_size(mesh), axis_index(mesh)
    m = pos.shape[0]
    start = me * m

    g = all_gather(torch.cat([pos, mass[:, None], _norms(vel)[:, None],
                              _norms(acc)[:, None]], 1), mesh)
    pos_g, mass_g = g[:, :3].contiguous(), g[:, 3].contiguous()
    codes_s, perm, box_lo, box_size = sort_by_morton(pos_g, cfg)
    pos_s, mass_s = pos_g[perm], mass_g[perm]
    v, a = g[perm, 4], g[perm, 5]
    if adaptive:
        ke = (torch.full((), cfg.rebuild_every, device=pos.device)
              if k_env is None else k_env)
        drift = adaptive_drift(v, a, codes_s, box_size, cfg,
                               k=ke.to(torch.float32))
        s_valid_t = validity_horizon(v, a, drift, cfg)
    else:
        ke = torch.full((), k, device=pos.device)
        drift = drift_bound(v, a, cfg, k)
        s_valid_t = ke

    # re-slab plan for the heavy per-particle rows (vel, acc, orig[, afm])
    h = min(max(cfg.force_tile, m // 4), m)
    plan = _reslab_plan(perm, m, h, mesh)

    cells, supers, bands, tables, my_pos = _classify_slab(
        pos_s, mass_s, codes_s, cfg, mesh, drift=drift)
    h_near = _near_halo_rows(m, cfg)
    n_far, starts_srv, wf_remap = _near_fetch_plan(bands, m, h_near, cfg,
                                                   mesh)
    # every replicated decision of the rebuild: one all-reduce of the
    # ranks' counts, then one host read of the sums and the horizon
    # (itself replicated: it comes from the gathered magnitudes)
    sums = comm.psum(torch.stack([plan.n_out,
                                  (n_far > cfg.near_fetch_cap).to(_I64),
                                  bands_overflowed(bands).to(_I64)]), mesh)
    n_out, n_bad, n_over, s_valid = torch.cat(
        [sums, s_valid_t.reshape(1)]).tolist()
    any_out, near_fast = n_out > 0, n_bad == 0
    # ENVELOPE FEEDBACK (the single-device loop's k_next_of): bands are
    # slab-local, so the overflow predicate is the ranks' sum
    k_next = k_next_of(ke, s_valid_t, sums[2] > 0, cfg)

    arrs = (vel, acc, orig) if afm is None else (vel, acc, orig, afm)
    reslabbed = _reslab(arrs, plan, any_out, h, mesh)
    my_vel, my_acc, my_orig = reslabbed[:3]
    my_afm = reslabbed[3] if afm is not None else None

    my_mass = mass_s[start:start + m]
    mass_src = reqs_g = None
    if near_fast:
        # the fixed-width mass halo and, with a fetch plan, every rank's
        # requests and the frozen masses of the fetched windows
        mass_src = _halo_ext(my_mass, h_near, mesh)
        if starts_srv is not None:
            reqs_g = all_gather(starts_srv, mesh).reshape(d, -1)      # [D, F]
            mass_src = torch.cat([mass_src,
                                  _fetch_windows(my_mass, reqs_g, m, mesh)])
    near_path = ("gather" if not near_fast
                 else "halo" if reqs_g is None else "halo+fetch")
    rctx = ((codes_s, drift, box_lo, box_size)
            if cfg.refresh_moments else None)
    return _Rebuilt(
        slab=(my_pos, my_vel, my_mass, my_acc, my_orig),
        built=(cells, supers, bands, tables, rctx),
        glob=_Glob(mass_s, mass_src, near_fast, reqs_g, wf_remap),
        s_valid=int(s_valid) if adaptive else k,
        k_next=k_next,
        afm=my_afm,
        paths=(near_path, "gather" if any_out else "halo"),
        sums=(n_out, n_bad, n_over),
    )


def _local_bh_step(pos, vel, mass, acc, cfg: SimConfig, mesh: Mesh):
    """The single-step path on LOCAL slabs of the ORIGINAL particle
    order [N/D, ...]: sort and cells replicated, classification, tables,
    the three sweeps and integration over this rank's slab of the sorted
    order."""
    pos_g = all_gather(pos, mesh)
    mass_g = all_gather(mass, mesh)
    codes_s, perm, _, _ = sort_by_morton(pos_g, cfg)
    ps, ms, cs = forces.pad_sorted(pos_g[perm], mass_g[perm], codes_s,
                                   cfg.force_tile)
    n_total = pos_g.shape[0]
    n_local = n_total // axis_size(mesh)

    _, supers, bands, tables, my_pos = _classify_slab(ps, ms, cs, cfg, mesh)
    acc_slab = forces.apply_bands(my_pos, None, supers, bands, tables, cfg,
                                  src_pos=ps, src_mass=ms)
    # re-assemble the sorted accelerations, back to the original order
    acc_s = all_gather(acc_slab, mesh)[:n_total]
    acc_orig = torch.empty_like(acc_s)
    acc_orig[perm] = acc_s
    me = axis_index(mesh)
    my_acc = acc_orig[me * n_local:(me + 1) * n_local]
    return integ.integrate(ParticleState(pos=pos, vel=vel, mass=mass,
                                         acc=acc), my_acc, cfg)


def make_sharded_step(cfg: SimConfig, mesh: Mesh):
    """The multi-device step: this rank's slab of a state in the original
    order (shard_state) -> the same slab one step later.  Requires
    n % (n_devices * force_tile) == 0 (make_sharded_runner handles any
    n by padding)."""
    _check_mesh(cfg, mesh)
    d = mesh.size
    if cfg.n % (d * cfg.force_tile):
        raise ValueError(
            f"n={cfg.n} must be a multiple of n_devices*force_tile="
            f"{d * cfg.force_tile} for the sharded step; "
            "make_sharded_runner handles arbitrary n by padding")

    def step(state: ParticleState) -> ParticleState:
        return _local_bh_step(*state, cfg, mesh)

    return step


# ---------------------------------------------------------------------------
# Sharded band-reuse runners (the production multi-device paths)
# ---------------------------------------------------------------------------


def _refresh_farmid_slab(p_mid, my_pos_live, mass_s, rctx, bands,
                         cfg: SimConfig, mesh: Mesh) -> torch.Tensor:
    """Sharded moment refresh (cfg.refresh_moments twin of
    forces.refresh_farmid): recompute every source moment from LIVE
    positions over the FROZEN cut (owner-computes windowed build against
    the rebuild-time quantization box + O(cells) stitch), regather MY
    slab's tables against the frozen classification, and evaluate
    far+mid at `p_mid`.  Wire cost: one live-position all_gather plus
    the stitch."""
    codes_s, drift, box_lo, box_size = rctx
    pos_live = all_gather(my_pos_live, mesh)
    cells_r, _ = _cells_sharded(codes_s, pos_live, mass_s, cfg, box_lo,
                                box_size, mesh, drift=drift)
    supers_r = forces.make_supers(cells_r)
    ss_r = forces.make_ss(supers_r, cfg)
    tables_r = forces.build_cell_tables(cells_r, supers_r, ss_r, bands,
                                         cfg)
    return forces.apply_farmid(p_mid, ss_r, tables_r, cfg)


def _near_source_rows(p: torch.Tensor, glob: _Glob, cfg: SimConfig,
                      mesh: Mesh) -> torch.Tensor:
    """The near sweep's live sources on the fast path: MY slab extended
    by the fixed 2h-row position halo, then the fetched windows' rows."""
    m = p.shape[0]
    p_src = _halo_ext(p, _near_halo_rows(m, cfg), mesh)
    if glob.reqs_g is None:
        return p_src
    return torch.cat([p_src, _fetch_windows(p, glob.reqs_g, m, mesh)])


def _near_sharded(p: torch.Tensor, glob: _Glob, bands, cfg: SimConfig,
                  mesh: Mesh) -> torch.Tensor:
    """The live near band of MY slab: over the halo (+ fetched) sources
    with the rebased windows when the cycle's plan holds, else over the
    live-position all_gather."""
    if glob.near_fast:
        return forces.apply_near(p, _near_source_rows(p, glob, cfg, mesh),
                                 glob.mass_src,
                                 bands._replace(win_first=glob.wf_remap), cfg)
    return forces.apply_near(p, all_gather(p, mesh), glob.mass_s, bands, cfg)


def _near_step(p, v_, my_mass, glob: _Glob, bands, afm, cfg: SimConfig,
               mesh: Mesh):
    """One integration step: slab-local far+mid (held, `afm`) + live
    near band."""
    a_ = afm + _near_sharded(p, glob, bands, cfg, mesh)
    st = integ.integrate(ParticleState(pos=p, vel=v_, mass=my_mass, acc=a_),
                         a_, cfg)
    return st.pos, st.vel, a_


def _sharded_cycles_body(pos, vel, mass, acc, orig, cfg: SimConfig,
                         mesh: Mesh, n_cycles: int, k: int):
    """Advance local slabs by n_cycles * k steps (fixed-K reuse,
    make_cycle_runner semantics).  Slabs are in the global sorted order
    of the latest rebuild; `orig` maps slab rows to original ids (pads
    -> n).  Each cycle: one o(N)-traffic rebuild, then k steps whose
    only communication feeds the near band.  With cfg.hold_farmid = R > 1
    dividing k, far+mid is held for R steps."""
    r = max(1, cfg.hold_farmid)
    if k % r:
        r = 1
    for _ in range(n_cycles):
        rb = _rebuild_sharded(pos, vel, mass, acc, orig, cfg, k,
                              adaptive=False, mesh=mesh)
        pos, vel, mass, acc, orig = rb.slab
        _, supers, bands, tables, _ = rb.built
        for _ in range(k // r):
            # held-refresh target sampling per cfg.hold_predict
            p_mid = hold_predict_pos(pos, vel, acc, 0.5 * (r - 1) * cfg.dt,
                                     cfg)
            afm = forces.apply_farmid(p_mid, supers, tables, cfg)
            for _ in range(r):
                pos, vel, acc = _near_step(pos, vel, mass, rb.glob, bands,
                                           afm, cfg, mesh)
    return pos, vel, mass, acc, orig


class _ShardedAdaptiveLoop(_AdaptiveLoop):
    """The adaptive schedule (models/simulation._AdaptiveLoop, shared
    step for step) over this rank's slab: the rebuild is
    _rebuild_sharded, the moment refresh _refresh_farmid_slab and the
    near band _near_sharded.  Every rank reads the same s_valid and the
    same summed predicates, so the ranks stay in lockstep.
    `host_reads` counts the host reads (one per rebuild), `paths` the
    near and reslab paths taken and `rebuild_sums` each rebuild's summed
    counts (_Rebuilt.sums)."""

    def __init__(self, cfg: SimConfig, mesh: Mesh, n: int, mass0, pos, vel,
                 mass, acc, orig):
        # eager: the gloo collectives stage through host memory and the
        # rebuild reads its predicates back, which no graph can capture
        self._start(cfg, n, mass0, pos, vel, mass, acc, orig, graphs=False)
        self.mesh = mesh
        self.glob = None
        self.host_reads = 0
        self.paths = collections.Counter()
        self.rebuild_sums = []

    def _build(self) -> int:
        rb = _rebuild_sharded(self.pos, self.vel, self.mass, self.acc,
                              self.orig, self.cfg, self.cfg.rebuild_every,
                              adaptive=True, mesh=self.mesh, k_env=self.k_env,
                              afm=self.afm if self.span else None)
        self._store(*rb.slab)
        self.built, self.glob = rb.built, rb.glob
        self.k_env.copy_(rb.k_next)
        if self.span:
            self.afm.copy_(rb.afm)
        self.host_reads += 1
        self.paths[f"near {rb.paths[0]}"] += 1
        self.paths[f"reslab {rb.paths[1]}"] += 1
        self.rebuild_sums.append(rb.sums)
        return rb.s_valid

    def _farmid_refreshed(self, p_mid: torch.Tensor) -> torch.Tensor:
        _, _, bands, _, rctx = self.built
        return _refresh_farmid_slab(p_mid, self.pos, self.glob.mass_s, rctx,
                                    bands, self.cfg, self.mesh)

    def _near(self, bands) -> torch.Tensor:
        return _near_sharded(self.pos, self.glob, bands, self.cfg, self.mesh)

    def snapshot(self) -> ParticleState:
        return _gather_back(self.pos, self.vel, self.acc, self.orig, self.n,
                            self.mass0, self.mesh)


def _gather_back(pos, vel, acc, orig, n: int, mass0,
                 mesh: Mesh) -> ParticleState:
    """Every rank's slab rows, scattered back to the original order (pad
    rows' orig == n are dropped): the full state on every rank."""
    g = all_gather(torch.cat([pos, vel, acc], 1), mesh)
    orig_g = all_gather(orig, mesh)
    return _unpad(g[:, 0:3], g[:, 3:6], g[:, 6:9], orig_g, n, mass0)


def _slabs_of(state: ParticleState, cfg: SimConfig, mesh: Mesh):
    """This rank's slab of the full state (gathered from every rank's
    shard_state slab), padded to a multiple of D * force_tile with
    massless clones: (n, mass, pos, vel, mass, acc, orig) with the
    global n and mass."""
    full = ParticleState(*(all_gather(x, mesh) for x in state))
    padded = _pad_cycle_state(full, mesh.size * cfg.force_tile)
    m = padded[0].shape[0] // mesh.size
    me = mesh.rank
    return (full.n, full.mass) + tuple(x[me * m:(me + 1) * m]
                                       for x in padded)


def make_sharded_runner(cfg: SimConfig, mesh: Mesh, n_cycles: int, k: int):
    """The multi-device FIXED-K band-reuse runner: advances a state by
    n_cycles * k steps.  Takes this rank's shard_state slab, returns the
    full state in the original order on every rank; pads n to a
    multiple of D * force_tile with massless clones, so any n works.
    Fixed-K reuse fails the kilostep physics gate once the core contracts
    (PERF.md): production runs use make_sharded_adaptive_runner."""

    _check_mesh(cfg, mesh)

    def run(state: ParticleState) -> ParticleState:
        n, mass0, *slab = _slabs_of(state, cfg, mesh)
        pos, vel, _, acc, orig = _sharded_cycles_body(*slab, cfg, mesh,
                                                      n_cycles, k)
        return _gather_back(pos, vel, acc, orig, n, mass0, mesh)

    return run


def make_sharded_adaptive_runner(cfg: SimConfig, mesh: Mesh, n_steps: int,
                                 return_stats: bool = False):
    """The multi-device ADAPTIVE band-reuse runner, the production
    config-5 path (make_adaptive_runner's schedule over slabs; the
    sharded_4m preset routes here through run_sharded).  Takes this
    rank's shard_state slab and returns the full state in the original
    order on every rank, with return_stats also the rebuild count (the
    same on every rank by construction)."""

    _check_mesh(cfg, mesh)

    def run(state: ParticleState):
        loop = _ShardedAdaptiveLoop(cfg, mesh, *_slabs_of(state, cfg, mesh))
        for _ in range(n_steps):
            loop.step()
        out = loop.snapshot()
        return (out, loop.n_rebuilds) if return_stats else out

    return run


def run_sharded(cfg: SimConfig, mesh: Mesh, state: ParticleState,
                n_steps: int) -> ParticleState:
    """Advance n_steps on the mesh with the production policy: the
    adaptive runner when cfg.adaptive_rebuild and cfg.rebuild_every > 1,
    else fixed-K cycles, else per-step rebuilds.  Takes this rank's
    shard_state slab; returns the full state."""
    k = cfg.rebuild_every
    if k > 1 and cfg.adaptive_rebuild:
        return make_sharded_adaptive_runner(cfg, mesh, n_steps)(state)
    if k <= 1:
        return make_sharded_runner(cfg, mesh, n_steps, 1)(state)
    n_cycles, rem = divmod(n_steps, k)
    full = ParticleState(*(all_gather(x, mesh) for x in state))
    if n_cycles:
        full = make_sharded_runner(cfg, mesh, n_cycles, k)(state)
        state = shard_state(full, mesh)
    if rem:
        full = make_sharded_runner(cfg, mesh, 1, rem)(state)
    return full


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """This rank's slab of a full state, rows [rank*n/D, (rank+1)*n/D),
    on the mesh device."""
    n, d = state.n, mesh.size
    if n % d:
        raise ValueError(f"n={n} does not split into {d} equal slabs")
    m = n // d
    return ParticleState(*(x[mesh.rank * m:(mesh.rank + 1) * m].to(
        mesh.device) for x in state))
