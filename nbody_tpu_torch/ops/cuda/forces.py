"""Wrappers of the CUDA force kernels (csrc/forces.cu).

Each wrapper takes the same arguments as its plain PyTorch version in
``nbody_tpu_torch.ops.forces``.  On CPU tensors it returns the plain
version; on CUDA tensors it checks device, dtype, shape and contiguity,
allocates the output, launches the kernel on the current stream and
raises if the launch failed.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import forces as _forces
from nbody_tpu_torch.ops.cuda import build
from nbody_tpu_torch.ops.cuda.launch import check, launched, on_cpu, stream

LAUNCHES = {"far_sweep": 0, "table_sweep": 0, "near_span": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def far_sweep(pos_s: torch.Tensor, supers: "_forces.Supers",
              cfg: SimConfig) -> torch.Tensor:
    """Kernel version of forces.far_sweep_torch."""
    if on_cpu(pos_s, supers.com, supers.gmass):
        return _forces.far_sweep_torch(pos_s, supers, cfg)
    f32 = torch.float32
    n = pos_s.shape[0]
    s = supers.gmass.shape[0]
    n_live = supers.n_supers.to(device=pos_s.device,
                                dtype=torch.int32).reshape(1)
    out = torch.empty((n, 3), dtype=f32, device=pos_s.device)
    rc = build.load("forces").nbody_far_sweep(
        check(pos_s, f32, (n, 3), "pos"), n,
        check(supers.com, f32, (s, 3), "com"),
        check(supers.gmass, f32, (s,), "gmass"), s,
        n_live.data_ptr(), _forces.soft_term(cfg), out.data_ptr(),
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
    planes = [check(p, f32, (t, rows), name) for p, name in
              zip(tables[:4], ("tx", "ty", "tz", "tm"))]
    rc = build.load("forces").nbody_table_sweep(
        check(tgt_pos, f32, (t * b, 3), "pos"), t, b, *planes, rows,
        check(tables.near_cnt, i32, (t,), "near_cnt"),
        check(tables.row_cnt, i32, (t,), "row_cnt"),
        cfg.near_cap, _forces.soft_term(cfg), out.data_ptr(),
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
    rc = build.load("forces").nbody_near_span(
        check(tgt_pos, f32, (t * b, 3), "tgt_pos"), t, b,
        check(src_pos, f32, (n_src, 3), "src_pos"),
        check(src_mass, f32, (n_src,), "src_mass"), n_src,
        check(win_first, i32, (t, w_cap), "win_first"),
        check(win_mask, i32, (t, 4, w_cap), "win_mask"),
        check(win_cnt, i32, (t,), "win_cnt"), w_cap,
        float(cfg.g), _forces.soft_term(cfg), out.data_ptr(),
        stream(tgt_pos))
    launched(rc, "near_span", LAUNCHES)
    return out
