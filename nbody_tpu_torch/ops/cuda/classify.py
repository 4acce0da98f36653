"""Wrapper of the CUDA band classifier (csrc/band_classify.cu).

``cell_band_lists`` takes the arguments of the plain
``forces.cell_band_lists_torch`` and returns the same ``CellBands``, bit
for bit, and writes the same demand (``forces.BAND_DEMAND``) into
``demand`` when given.  On CPU tensors it returns the plain version; on
CUDA tensors ``kernel_args`` checks device, dtype, shape and contiguity
and allocates the outputs at the static caps, and the kernel is launched
once on the
current stream, with no host read, so a rebuild that calls it still
captures into a CUDA graph.  ``LAUNCHES`` counts its launches, under a
graph's replay too (``launch.uncounted`` and ``launch.add``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import forces as _forces
from nbody_tpu_torch.ops.cuda import build
from nbody_tpu_torch.ops.cuda.launch import (check, counter, launched,
                                             on_cpu, stream)

LAUNCHES = counter("band_classify")

# The C struct ClassifyArgs of csrc/band_classify.cu, field for field:
# input pointers, output pointers, sizes and caps, then the floats.
_INPUTS = ("tgt_center", "tgt_radius", "tgt_skin",
           "ss_com", "ss_diam", "ss_skin", "ss_gmass",
           "sup_com", "sup_diam", "sup_skin", "sup_gmass",
           "cell_com", "cell_diam", "cell_skin",
           "kid_com", "kid_diam", "kid_gmass", "kid_skin", "kid_gdiam",
           "kid_complete", "kid_first", "kid_count",
           "gkid_com", "gkid_gmass")
_OUTPUTS = ("ss_idx", "ss_cnt", "sup_idx", "sup_cnt", "mid_idx", "mid_cnt",
            "cmid_idx", "cmid_cnt", "near_idx", "near_cnt", "win_first",
            "win_mask", "win_cnt", "flags", "demand")
_SIZES = ("tiles", "n_ss", "n_sup", "g_cap", "ss_cap", "sup_cap", "mid_cap",
          "cmid_cap", "near_cap", "win_cap", "pieces")
_FLOATS = ("half", "soft", "theta")

# The dynamic shared memory a block may opt in to on an H100 (227 KB), less
# the kernel's static shared arrays.
SMEM_LIMIT = 227 * 1024 - 256
# The longest near list the kernel keeps in shared memory (kNearSmem); a
# longer one it builds in its output row.
NEAR_SMEM = 8192


def smem_bytes(cfg: SimConfig) -> int:
    """The dynamic shared memory the kernel takes at cfg's caps: the ss,
    sup and mid lists, the near list up to NEAR_SMEM entries, and the
    window keys and words."""
    near = cfg.near_cap if cfg.near_cap <= NEAR_SMEM else 0
    return 4 * (cfg.ss_cap + cfg.sup_cap + cfg.mid_cap + near
                + 5 * cfg.win_cap_eff)


class ClassifyArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _INPUTS + _OUTPUTS]
                + [(f, ctypes.c_int) for f in _SIZES]
                + [(f, ctypes.c_float) for f in _FLOATS])


def kernel_args(tgt_subs: "_forces.GroupInfo", ss: "_forces.Supers",
                supers: "_forces.Supers", cells, cfg: SimConfig, skin=0.0,
                demand=None) -> Tuple[ClassifyArgs, "_forces.CellBands"]:
    """The kernel's argument block and the CellBands it fills, allocated
    on the inputs' device, with `demand` (int32 [6], zeroed; allocated
    when None); raises on a dtype, shape or layout the kernel does not
    take."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    n_ss = ss.com.shape[0]
    n_sup = supers.com.shape[0]
    g_cap = cells.com.shape[0]
    t8 = tgt_subs.center.shape[0]
    if t8 % _forces.SUB_FACTOR:
        raise ValueError(f"{t8} sub-spheres are not whole tiles of "
                         f"{_forces.SUB_FACTOR}")
    if not (8 * (n_ss - 1) < n_sup <= 8 * n_ss and g_cap == 8 * n_sup):
        raise ValueError(f"levels do not nest by 8: {n_ss} super-supers, "
                         f"{n_sup} supers, {g_cap} cells")
    t = t8 // _forces.SUB_FACTOR
    ptrs = {
        "tgt_center": check(tgt_subs.center, f32, (t8, 3), "center"),
        "tgt_radius": check(tgt_subs.radius, f32, (t8,), "radius"),
        "tgt_skin": check(tgt_subs.skin, f32, (t8,), "tgt skin"),
    }
    for pre, lvl, n in (("ss", ss, n_ss), ("sup", supers, n_sup)):
        ptrs[f"{pre}_com"] = check(lvl.com, f32, (n, 3), f"{pre} com")
        for f in ("diam", "skin", "gmass"):
            ptrs[f"{pre}_{f}"] = check(getattr(lvl, f), f32, (n,),
                                       f"{pre} {f}")
    ptrs["cell_com"] = check(cells.com, f32, (g_cap, 3), "cell com")
    for f in ("diam", "skin"):
        ptrs[f"cell_{f}"] = check(getattr(cells, f), f32, (g_cap,), f)
    ptrs["kid_com"] = check(cells.child_com, f32, (g_cap, 8, 3), "child_com")
    for key, name, dt in (("kid_diam", "child_diam", f32),
                          ("kid_gmass", "child_gmass", f32),
                          ("kid_skin", "child_skin", f32),
                          ("kid_gdiam", "gchild_diam_max", f32),
                          ("kid_complete", "gchild_complete", torch.bool),
                          ("kid_first", "child_first", i64),
                          ("kid_count", "child_count", i64)):
        ptrs[key] = check(getattr(cells, name), dt, (g_cap, 8), name)
    ptrs["gkid_com"] = check(cells.gchild_com, f32, (g_cap, 8, 8, 3),
                             "gchild_com")
    ptrs["gkid_gmass"] = check(cells.gchild_gmass, f32, (g_cap, 8, 8),
                               "gchild_gmass")

    dev = tgt_subs.center.device
    w = cfg.win_cap_eff

    def out(*shape):
        return torch.empty((t,) + shape, dtype=i32, device=dev)

    flags = torch.zeros(5, dtype=torch.bool, device=dev)
    bands = _forces.CellBands(
        ss_idx=out(cfg.ss_cap), ss_cnt=out(),
        sup_idx=out(cfg.sup_cap), sup_cnt=out(),
        mid_idx=out(cfg.mid_cap), mid_cnt=out(),
        cmid_idx=out(cfg.cmid_cap), cmid_cnt=out(),
        near_idx=out(cfg.near_cap), near_cnt=out(),
        win_first=out(w), win_mask=out(4, w), win_cnt=out(),
        ss_overflow=flags[0], sup_overflow=flags[1], mid_overflow=flags[2],
        cmid_overflow=flags[3], near_overflow=flags[4])
    if demand is None:
        demand = torch.zeros(len(_forces.BAND_DEMAND), dtype=i32, device=dev)
    ptrs.update({f: getattr(bands, f).data_ptr() for f in _OUTPUTS[:-2]})
    ptrs["flags"] = flags.data_ptr()
    ptrs["demand"] = check(demand, i32, (len(_forces.BAND_DEMAND),),
                           "demand")
    sizes = dict(tiles=t, n_ss=n_ss, n_sup=n_sup, g_cap=g_cap,
                 ss_cap=cfg.ss_cap, sup_cap=cfg.sup_cap, mid_cap=cfg.mid_cap,
                 cmid_cap=cfg.cmid_cap, near_cap=cfg.near_cap, win_cap=w,
                 pieces=cfg.win_pieces)
    args = ClassifyArgs(**ptrs, **sizes, half=0.5 * float(skin),
                        soft=_forces.soft_term(cfg), theta=cfg.theta)
    return args, bands


def cell_band_lists(tgt_subs: "_forces.GroupInfo", ss: "_forces.Supers",
                    supers: "_forces.Supers", cells, cfg: SimConfig,
                    skin=0.0, demand=None) -> "_forces.CellBands":
    """Kernel version of forces.cell_band_lists_torch."""
    if on_cpu(tgt_subs.center, ss.com, supers.com, cells.com,
              cells.child_com):
        return _forces.cell_band_lists_torch(tgt_subs, ss, supers, cells, cfg,
                                             skin=skin, demand=demand)
    args, bands = kernel_args(tgt_subs, ss, supers, cells, cfg, skin, demand)
    rc = build.load("band_classify").nbody_band_classify(
        ctypes.addressof(args), stream(tgt_subs.center))
    launched(rc, "band_classify", LAUNCHES)
    return bands
