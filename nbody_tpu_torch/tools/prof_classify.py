"""Stage prefixes of the band classifier (port of tools/_prof_classify.py):
which stage of the plain classifier, forces.cell_band_lists_torch, costs
the time at 1M?  A trimmed copy of it that stops after a named stage, so
the deltas between lines attribute its cost.  The card's production path
is not this copy but the CUDA kernel (csrc/band_classify.cu, one launch a
build, bit for bit the plain version's): its time and launches print
beside the stages (on the CPU that line is the plain version itself).

    python -m nbody_tpu_torch.tools.prof_classify [n] [key=val ...]
        [--hot-state PATH] [--device cuda]

--hot-state is NBODY_HOT_STATE: the classifier at that checkpoint
instead of the initial conditions.  The tool's own config is
SimConfig(n, check_overflow=False) plus the overrides (63-bit codes,
force_tile 256, super-supers on); the build has no skins, as the JAX
tool's.

The stages copy what the classifier computes now.  The JAX tool's copy
is older than its own package's classifier: it starts at the supers,
with no super-super stage and no target skins.  Here:

  stage0    the super-super MAC (no JAX tool stage)
  compact0  its row compaction
  stage1    the member supers of the failing super-supers (JAX: stage1)
  compact1  their compaction (JAX: compact1)
  stage2    the failing supers' cells (JAX: stage2)
  compact2  (JAX: compact2)
  stage3    the failing cells' children, cmid or near (JAX: stage3)
  compact3  both compactions (JAX: compact3)
  pieces    the near runs split into aligned window pieces
            (forces._pieces)
  merge     the window ranks (a cumsum) and the segmented sum of the lane
            masks (index_add_): JAX "winscan", whose associative OR-scan
            this stands for
  windows   the whole forces._window_masks: JAX "winsort" and "windows"
            (the port has no pack sort)

The windows take cfg.win_pieces pieces a run (the port declines the
JAX default of 2).  Each stage returns per-tile counts: failing or kept
entries per row, live pieces, distinct windows before the cap, win_cnt.
Each stage's time is the median of 6 calls after one (CUDA events around
each call on the card, the host clock on the CPU); the JAX tool's relay
subtraction has no counterpart.  Beside it, the aten ops the stage
dispatches, views left out (each one kernel launch or more); the
production line counts its kernel launches too.
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import bbox, forces
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.cuda import classify
from nbody_tpu_torch.ops.forces import SUB_FACTOR, _BIG, _BIG_F, _I64, \
    _norm3, _pieces, _row_compact_one, _window_masks, soft_term
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.tools import common

STAGES = ("stage0", "compact0", "stage1", "compact1", "stage2", "compact2",
          "stage3", "compact3", "pieces", "merge", "windows")


def make_config(n: int = 1_000_000, overrides: dict | None = None
                ) -> SimConfig:
    return SimConfig(n=n, check_overflow=False).replace(**(overrides or {}))


def upstream(state: ParticleState, cfg: SimConfig):
    """(target sub-spheres, super-supers, supers, cells) of the unskinned
    build at `state`, as forces.build_bands makes them."""
    ps, ms, cs, _, _, _ = common.sorted_padded(state, cfg)
    lo, size = bbox.bounding_cube(ps)
    cells = build_source_cells(cs, ps, ms, cfg.force_tile, cfg.g,
                               cfg.cell_capacity, lo, size,
                               g2_factor=cfg.g2_cap_factor,
                               bits=cfg.morton_bits)
    supers = forces.make_supers(cells)
    tgt = forces.target_subspheres(ps, cfg.force_tile, codes=cs,
                                   bits=cfg.morton_bits)
    return tgt, forces.make_ss(supers, cfg), supers, cells


def classify_until(upto: str, tgt_subs, ss, supers, cells,
                   cfg: SimConfig) -> torch.Tensor:
    """forces.cell_band_lists_torch (skin 0) up to stage `upto`: per-tile
    counts [T] ([T, 2] (cmid, near) at stage3 and compact3)."""
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
    f32 = torch.float32

    def zero_row(x):
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])

    supf = torch.cat([supers.com, supers.diam[:, None], supers.skin[:, None],
                      supers.gmass[:, None]], dim=1)
    if 8 * n_ss != n_sup:
        supf = torch.cat([supf, supf.new_zeros((8 * n_ss - n_sup, 6))])
    supf8 = zero_row(supf.reshape(n_ss, 8, 6))
    cellf = torch.cat([cells.com, cells.diam[:, None], cells.skin[:, None]], 1)
    cellf8 = zero_row(cellf.reshape(n_sup, 8, 5))
    cellf6 = torch.cat([cellf8, torch.ones(cellf8.shape[:2] + (1,), dtype=f32,
                                           device=dev)], dim=-1)
    gc_ok = (cells.gchild_gmass > 0)[..., None]
    gc_lo = torch.where(gc_ok, cells.gchild_com, _BIG_F).amin(dim=2)
    gc_hi = torch.where(gc_ok, cells.gchild_com, -_BIG_F).amax(dim=2)
    kidf = zero_row(torch.cat(
        [cells.child_com, cells.child_diam[..., None],
         cells.gchild_diam_max[..., None], gc_lo, gc_hi,
         cells.child_gmass[..., None], cells.child_skin[..., None],
         cells.gchild_complete.to(f32)[..., None]], dim=-1))
    fc_flat = zero_row(torch.stack([cells.child_first.reshape(-1),
                                    cells.child_count.reshape(-1)], dim=1))

    centers = tgt_subs.center.reshape(t, SUB_FACTOR, 3)
    radii = tgt_subs.radius.reshape(t, SUB_FACTOR)
    tskins = tgt_subs.skin.reshape(t, SUB_FACTOR)
    per_row = 24 * n_ss + 120 * ss_cap + 120 * s_cap + 250 * mid_cap
    chunk = max(8, min(256, (28 << 20) // max(per_row, 1)))
    ss_ids = torch.arange(n_ss, device=dev)[None, :]
    arange8 = torch.arange(8, device=dev)

    def live(keys):
        return (keys < big).sum(dim=1)

    def one_chunk(ctr, rad, tsk):
        c_rows = ctr.shape[0]
        rad_t = rad + tsk

        def sub_gap(com, src_skin):
            gap = _norm3(com[:, :, None, :] - ctr[:, None, :, :]) \
                - rad_t[:, None, :]
            gap = torch.clamp(gap.amin(dim=-1), min=0.0)
            return torch.clamp(gap - src_skin, min=0.0)

        def gated_mac(idx_list, pack, n_rows, id_cap):
            ids = torch.clamp(idx_list, max=n_rows)
            f = pack[ids].reshape(c_rows, -1, 6)
            kid = (ids[:, :, None] * 8 + arange8).reshape(c_rows, -1)
            sk = f[..., 4]
            g = sub_gap(f[..., 0:3], f[..., 4])
            dist = torch.sqrt(g * g + soft)
            fail = (((f[..., 3] + 2.0 * sk) / dist >= theta)
                    & (f[..., 5] > 0) & (kid < id_cap))
            return torch.where(fail, kid, big)

        gap = _norm3(ss.com[None, :, None, :] - ctr[:, None, :, :]) \
            - rad_t[:, None, :]
        sssk = ss.skin[None, :]
        gap = torch.clamp(torch.clamp(gap.amin(dim=-1), min=0.0) - sssk,
                          min=0.0)
        dist = torch.sqrt(gap * gap + soft)
        keys = torch.where(((ss.diam[None, :] + 2.0 * sssk) / dist >= theta)
                           & (ss.gmass > 0)[None, :], ss_ids, big)
        if upto == "stage0":
            return live(keys)
        ss_idx, ss_cnt = _row_compact_one(keys, big, ss_cap)
        if upto == "compact0":
            return ss_cnt
        keys = gated_mac(ss_idx, supf8, n_ss, 8 * n_ss)
        if upto == "stage1":
            return live(keys)
        sup_idx, sup_cnt = _row_compact_one(keys, big, s_cap)
        if upto == "compact1":
            return sup_cnt
        keys = gated_mac(sup_idx, cellf6, n_sup, g_cap)
        if upto == "stage2":
            return live(keys)
        mid_idx, mc_raw = _row_compact_one(keys, big, mid_cap)
        if upto == "compact2":
            return mc_raw

        midc = torch.clamp(mid_idx, max=g_cap)
        kf = kidf[midc].reshape(c_rows, -1, 14)
        kid_id = (midc[:, :, None] * 8 + arange8).reshape(c_rows, -1)
        ksk = kf[..., 12]
        g = sub_gap(kf[..., 0:3], kf[..., 12])
        distk = torch.sqrt(g * g + soft)
        alive = (kf[..., 11] > 0) & (kid_id < k_cap)
        failk = ((kf[..., 3] + 2.0 * ksk) / distk >= theta) & alive
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
        if upto == "stage3":
            return torch.stack([cmid_m.sum(dim=1), near_m.sum(dim=1)], 1)
        _, cc = _row_compact_one(torch.where(cmid_m, kid_id, big), big,
                                 cmid_cap)
        ni, nc = _row_compact_one(torch.where(near_m, kid_id, big), big,
                                  near_cap)
        if upto == "compact3":
            return torch.stack([cc, nc], 1)

        fc = fc_flat[torch.clamp(ni, max=k_cap)]
        first, count = fc[..., 0], fc[..., 1]
        p = cfg.win_pieces
        if upto == "windows":
            return _window_masks(first, count, cfg.win_cap_eff, p)[2]
        key, words = _pieces(first.to(_I64), count.to(_I64), p, big)
        if upto == "pieces":
            return (words != 0).any(dim=-1).sum(dim=1)
        # _window_masks' merge: ranks, the win_cap child drop, the sum
        width = key.shape[1]
        bnd = torch.cat([torch.ones_like(key[:, :1], dtype=torch.bool),
                         key[:, 1:] != key[:, :-1]], dim=1)
        rank = torch.cumsum(bnd.to(_I64), dim=1) - 1
        drop = (count > 0) & (rank[:, p - 1::p] >= cfg.win_cap_eff)
        words = torch.where(drop.repeat_interleave(p, dim=1)[..., None], 0,
                            words.to(_I64) & 0xFFFFFFFF)
        flat = (rank + width * torch.arange(c_rows, device=dev)[:, None])
        acc = torch.zeros((c_rows * width, 4), dtype=_I64, device=dev)
        acc.index_add_(0, flat.reshape(-1), words.reshape(-1, 4))
        return (bnd & (key < big)).sum(dim=1)

    return torch.cat([one_chunk(centers[i:i + chunk], radii[i:i + chunk],
                                tskins[i:i + chunk])
                      for i in range(0, t, chunk)])


def stage_times(state: ParticleState, cfg: SimConfig, stages=STAGES,
                iters: int = 6) -> dict:
    """{"ms": {stage: median ms}, "ops": {stage: aten ops dispatched,
    views left out (common.op_count)}, "counts": {stage: per-tile
    counts}, "production": {"route", "launches", "ms", "ops"}}, the last
    for the whole production classifier (forces.cell_band_lists: the
    kernel on the card with cfg.use_pallas, else the plain version)
    timed the same way, its launches counted over one call."""
    up = upstream(state, cfg)
    times, ops, counts = {}, {}, {}
    for s in stages:
        def fn(s=s):
            return classify_until(s, *up, cfg)

        counts[s] = fn()
        times[s] = common.device_times(fn, state.device, iters)["median_ms"]
        ops[s] = common.op_count(fn)

    def prod():
        return forces.cell_band_lists(*up, cfg)

    before = classify.LAUNCHES["band_classify"]
    prod()
    launches = classify.LAUNCHES["band_classify"] - before
    production = {"route": "cuda" if launches else "plain",
                  "launches": launches,
                  "ms": common.device_times(prod, state.device,
                                            iters)["median_ms"],
                  "ops": common.op_count(prod)}
    return {"ms": times, "ops": ops, "counts": counts,
            "production": production}


def report(r: dict) -> str:
    lines = [f"{k:10s} {v:8.2f} ms  {r['ops'][k]:5d} ops"
             for k, v in r["ms"].items()]
    p = r["production"]
    name = "kernel" if p["route"] == "cuda" else "plain"
    lines.append(f"{name:10s} {p['ms']:8.2f} ms  {p['ops']:5d} ops  "
                 f"{p['launches']} launch(es): the production classifier")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("overrides", nargs="*", help="key=val SimConfig fields")
    ap.add_argument("--hot-state", default="")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    over = common.parse_overrides(args.overrides)
    if args.hot_state:
        state, at = common.load_state(args.hot_state, args.n, dev)
        print(f"  loaded {args.hot_state} (step {at})", flush=True)
        cfg = make_config(state.n, over)
    else:
        cfg = make_config(args.n, over)
        state = Simulation(cfg, device=dev).init_state()
    print(f"[classify] caps ss={cfg.ss_cap} sup={cfg.sup_cap} "
          f"mid={cfg.mid_cap} cmid={cfg.cmid_cap} near={cfg.near_cap} "
          f"win={cfg.win_cap_eff} pieces={cfg.win_pieces} ({dev.type})",
          flush=True)
    print(report(stage_times(state, cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
