"""Wrappers of the CUDA force kernels (csrc/tile_sweeps.cu: the far,
table and near-span sweeps).

Each wrapper takes the same arguments as its plain PyTorch version in
``nbody_tpu_torch.ops.forces``.  On CPU tensors it returns the plain
version; on CUDA tensors it checks device, dtype, shape and contiguity,
allocates the output (and, for the two per-tile kernels, the
heaviest-first tile order), launches the kernel on the current stream
and raises if the launch failed.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its path went through the kernels; under
a CUDA graph's replay too (``launch.uncounted`` and ``launch.add``).
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import forces as _forces
from nbody_tpu_torch.ops.cuda import build
from nbody_tpu_torch.ops.cuda.launch import (check, counter, launched,
                                             on_cpu, stream)

LAUNCHES = counter("far_sweep", "table_sweep", "near_span")


def heavy_first(work: torch.Tensor) -> torch.Tensor:
    """Tile indices by falling `work` ([T] int64, ties in tile order),
    computed on the tensor's device with no host read.  Block i of a
    per-tile kernel takes tile order[i], so the longest tiles start first
    and do not form the launch's tail; the sums do not depend on it."""
    return torch.argsort(work, descending=True, stable=True)


# The far kernel's block (tile_sweeps.cu kThreads) and targets per thread
# (kFarTargets).
FAR_THREADS = 128
FAR_TARGETS = 2


def far_blocks(n: int) -> int:
    """Blocks of the far sweep for n targets: one per FAR_TARGETS *
    FAR_THREADS targets, the last one masked."""
    return max(1, -(-n // (FAR_TARGETS * FAR_THREADS)))


def far_sweep(pos_s: torch.Tensor, supers: "_forces.Supers",
              cfg: SimConfig) -> torch.Tensor:
    """Kernel version of forces.far_sweep_torch (the kernel reads the live
    count, an int64 on the device, itself)."""
    if on_cpu(pos_s, supers.com, supers.gmass, supers.n_supers):
        return _forces.far_sweep_torch(pos_s, supers, cfg)
    f32 = torch.float32
    n = pos_s.shape[0]
    s = supers.gmass.shape[0]
    out = torch.empty((n, 3), dtype=f32, device=pos_s.device)
    rc = build.load("tile_sweeps").nbody_far_sweep(
        check(pos_s, f32, (n, 3), "pos"), n,
        check(supers.com, f32, (s, 3), "com"),
        check(supers.gmass, f32, (s,), "gmass"), s,
        check(supers.n_supers, torch.int64, (), "n_supers"),
        _forces.soft_term(cfg), out.data_ptr(), far_blocks(n),
        stream(pos_s))
    launched(rc, "far_sweep", LAUNCHES)
    return out


def table_sweep(tgt_pos: torch.Tensor, tables: "_forces.TableSet",
                cfg: SimConfig) -> torch.Tensor:
    """Kernel version of forces.table_sweep_torch."""
    if on_cpu(tgt_pos, tables.tx):
        return _forces.table_sweep_torch(tgt_pos, tables, cfg)
    f32, i32 = torch.float32, torch.int32
    b = cfg.force_tile
    t, rows = tables.tx.shape
    if t * b != tgt_pos.shape[0]:
        raise ValueError(f"{tgt_pos.shape[0]} targets are not {t} tiles of {b}")
    out = torch.empty((t * b, 3), dtype=f32, device=tgt_pos.device)
    order = heavy_first(tables.near_cnt + tables.row_cnt)
    planes = [check(p, f32, (t, rows), name) for p, name in
              zip(tables[:4], ("tx", "ty", "tz", "tm"))]
    rc = build.load("tile_sweeps").nbody_table_sweep(
        check(tgt_pos, f32, (t * b, 3), "pos"), t, b, *planes, rows,
        check(tables.near_cnt, i32, (t,), "near_cnt"),
        check(tables.row_cnt, i32, (t,), "row_cnt"),
        cfg.near_cap, order.data_ptr(), _forces.soft_term(cfg),
        out.data_ptr(),
        stream(tgt_pos))
    launched(rc, "table_sweep", LAUNCHES)
    return out


def near_span(tgt_pos: torch.Tensor, src_pos: torch.Tensor,
              src_mass: torch.Tensor, win_first: torch.Tensor,
              win_mask: torch.Tensor, win_cnt: torch.Tensor,
              cfg: SimConfig) -> torch.Tensor:
    """Kernel version of forces.near_correction_torch."""
    if on_cpu(tgt_pos, src_pos, win_first):
        return _forces.near_correction_torch(tgt_pos, src_pos, src_mass,
                                             win_first, win_mask, win_cnt, cfg)
    f32, i32 = torch.float32, torch.int32
    b = cfg.force_tile
    t, w_cap = win_first.shape
    n_src = src_pos.shape[0]
    if t * b != tgt_pos.shape[0]:
        raise ValueError(f"{tgt_pos.shape[0]} targets are not {t} tiles of {b}")
    out = torch.empty((t * b, 3), dtype=f32, device=tgt_pos.device)
    order = heavy_first(win_cnt)
    rc = build.load("tile_sweeps").nbody_near_span(
        check(tgt_pos, f32, (t * b, 3), "tgt_pos"), t, b,
        check(src_pos, f32, (n_src, 3), "src_pos"),
        check(src_mass, f32, (n_src,), "src_mass"), n_src,
        check(win_first, i32, (t, w_cap), "win_first"),
        check(win_mask, i32, (t, 4, w_cap), "win_mask"),
        check(win_cnt, i32, (t,), "win_cnt"), w_cap, order.data_ptr(),
        float(cfg.g), _forces.soft_term(cfg), out.data_ptr(),
        stream(tgt_pos))
    launched(rc, "near_span", LAUNCHES)
    return out


# Floats from 2^-100 up where the far and table sweeps' one-SFU 1 / sqrt
# may differ from IEEE sqrt and division: two per odd binade
# (tile_sweeps.cu, inv_sqrt_rn).
INV_SQRT_TIES = 2 * 114


def inv_sqrt_mismatches(device: torch.device) -> int:
    """How many float32 values in [2^-100, inf) the far and table sweeps'
    one-SFU 1 / sqrt rounds differently from IEEE sqrt and division, every
    one of them tried on `device`; the sweeps' agreement with their plain
    versions rests on no more than INV_SQRT_TIES."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    rc = build.load("tile_sweeps").nbody_inv_sqrt_check(
        (127 - 100) << 23, 0x7F800000, bad.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inv_sqrt check launch failed: CUDA error {rc}")
    return int(bad)


def inv_sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The sweeps' one-SFU 1 / sqrt of each element of a float32 CUDA
    tensor (to trace a far-sweep mismatch to a tie)."""
    if x.device.type != "cuda":
        raise ValueError("inv_sqrt_rn runs on a CUDA tensor")
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = build.load("tile_sweeps").nbody_inv_sqrt_eval(
        check(x, torch.float32, x.shape, "x"), x.numel(), out.data_ptr(),
        stream(x))
    if rc != 0:
        raise RuntimeError(f"inv_sqrt_rn launch failed: CUDA error {rc}")
    return out
