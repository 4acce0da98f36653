"""Wrapper of the CUDA band-table build (csrc/band_tables.cu).

``build_cell_tables`` takes the arguments of the plain
``forces.build_cell_tables_torch`` and returns a ``TableSet`` of the same
shapes and dtypes whose live rows, [0, near_cnt) and [near_cap, row_cnt)
of each tile, and counts are the plain version's bit for bit; the kernel
writes no other row (``TableSet``'s contract).  On CPU tensors it returns
the plain version; on CUDA tensors ``kernel_args`` checks device, dtype,
shape and contiguity and allocates the planes at the static caps, and
the kernel is launched once on the current stream, with no host read, so
a band build that calls it still captures into a CUDA graph.
``LAUNCHES`` counts its launches, under a graph's replay too
(``launch.uncounted`` and ``launch.add``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from nbody_tpu_torch.ops import forces as _forces
from nbody_tpu_torch.ops.cuda import build
from nbody_tpu_torch.ops.cuda.launch import (check, counter, launched,
                                             on_cpu, stream)

LAUNCHES = counter("table_build")

# The C struct TablesArgs of csrc/band_tables.cu, field for field: input
# pointers, output pointers, then the sizes and caps.
_LEVELS = ("ss", "sup", "cell", "kid", "gkid")
_LISTS = ("ss", "sup", "mid", "cmid", "near")
_INPUTS = (tuple(f"{lv}_{f}" for lv in _LEVELS for f in ("com", "gmass"))
           + tuple(f"{ls}_{f}" for ls in _LISTS for f in ("idx", "cnt")))
_OUTPUTS = ("tx", "ty", "tz", "tm", "row_cnt", "near_cnt_out")
_SIZES = ("tiles", "n_ss", "n_sup", "g_cap", "ss_cap", "sup_cap", "mid_cap",
          "cmid_cap", "near_cap", "splits")

# The table rows a block of the kernel (256 threads) is sized for: a tile
# takes its row width over ROWS_PER_BLOCK blocks, at most MAX_SPLITS, so
# the live rows of a dense tile spread over many SMs.
ROWS_PER_BLOCK = 4096
MAX_SPLITS = 64


def splits(rows: int) -> int:
    """Blocks a tile for table rows `rows` wide."""
    return max(1, min(MAX_SPLITS, -(-rows // ROWS_PER_BLOCK)))


class TablesArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _INPUTS + _OUTPUTS]
                + [(f, ctypes.c_int) for f in _SIZES])


def kernel_args(cells, supers: "_forces.Supers", ss: "_forces.Supers",
                bands: "_forces.CellBands"
                ) -> Tuple[TablesArgs, "_forces.TableSet"]:
    """The kernel's argument block and the TableSet it fills, allocated on
    the inputs' device at the lists' widths; raises on a dtype, shape or
    layout the kernel does not take."""
    f32, i32 = torch.float32, torch.int32
    n_ss = ss.com.shape[0]
    n_sup = supers.com.shape[0]
    g_cap = cells.com.shape[0]
    if not (8 * (n_ss - 1) < n_sup <= 8 * n_ss and g_cap == 8 * n_sup):
        raise ValueError(f"levels do not nest by 8: {n_ss} super-supers, "
                         f"{n_sup} supers, {g_cap} cells")
    t = bands.near_idx.shape[0]
    levels = {"ss": (ss.com, ss.gmass, (n_ss,)),
              "sup": (supers.com, supers.gmass, (n_sup,)),
              "cell": (cells.com, cells.gmass, (g_cap,)),
              "kid": (cells.child_com, cells.child_gmass, (g_cap, 8)),
              "gkid": (cells.gchild_com, cells.gchild_gmass, (g_cap, 8, 8))}
    ptrs = {}
    for lv, (com, gmass, shape) in levels.items():
        ptrs[f"{lv}_com"] = check(com, f32, shape + (3,), f"{lv} com")
        ptrs[f"{lv}_gmass"] = check(gmass, f32, shape, f"{lv} gmass")
    caps = {}
    for ls in _LISTS:
        idx = getattr(bands, f"{ls}_idx")
        caps[ls] = idx.shape[-1]
        ptrs[f"{ls}_idx"] = check(idx, i32, (t, caps[ls]), f"{ls}_idx")
        ptrs[f"{ls}_cnt"] = check(getattr(bands, f"{ls}_cnt"), i32, (t,),
                                  f"{ls}_cnt")
    rows = caps["near"] + 9 * sum(caps[ls] for ls in _LISTS[:4])
    if rows >= 1 << 31:
        raise ValueError(f"{rows} table rows a tile are past the kernel's "
                         f"int32 row index")

    dev = cells.com.device
    planes = torch.empty((4, t, rows), dtype=f32, device=dev)
    tables = _forces.TableSet(
        tx=planes[0], ty=planes[1], tz=planes[2], tm=planes[3],
        row_cnt=torch.empty(t, dtype=i32, device=dev),
        near_cnt=torch.empty(t, dtype=i32, device=dev))
    ptrs.update({f: x.data_ptr() for f, x in zip(_OUTPUTS, tables)})
    sizes = dict(tiles=t, n_ss=n_ss, n_sup=n_sup, g_cap=g_cap,
                 ss_cap=caps["ss"], sup_cap=caps["sup"], mid_cap=caps["mid"],
                 cmid_cap=caps["cmid"], near_cap=caps["near"],
                 splits=splits(rows))
    return TablesArgs(**ptrs, **sizes), tables


def build_cell_tables(cells, supers: "_forces.Supers", ss: "_forces.Supers",
                      bands: "_forces.CellBands") -> "_forces.TableSet":
    """Kernel version of forces.build_cell_tables_torch (live rows only)."""
    if on_cpu(cells.com, supers.com, ss.com, bands.near_idx):
        return _forces.build_cell_tables_torch(cells, supers, ss, bands)
    args, tables = kernel_args(cells, supers, ss, bands)
    rc = build.load("band_tables").nbody_band_tables(
        ctypes.addressof(args), stream(cells.com))
    launched(rc, "table_build", LAUNCHES)
    return tables


def live_diff(got: "_forces.TableSet", want: "_forces.TableSet",
              near_cap: int) -> list:
    """The fields of `got` that differ from `want` in any bit of a live
    row (want's: forces.live_rows) or in the counts; [] when the live
    rows and the counts are the same."""
    if got.tx.shape != want.tx.shape:
        return ["shape"]
    live = _forces.live_rows(want.near_cnt, want.row_cnt, near_cap,
                             want.tx.shape[1])
    bad = [f for f, g, w in zip(_forces.TableSet._fields[:4], got, want)
           if not torch.equal(g.view(torch.int32)[live],
                              w.view(torch.int32)[live])]
    return bad + [f for f in ("row_cnt", "near_cnt")
                  if not torch.equal(getattr(got, f), getattr(want, f))]
