"""Wrapper of the CUDA panel-sweep kernel (csrc/panel.cu), the port of
tools/_prof_mxu.py:sweep.

``sweep(variant, pos3, gx, gy, gz, gm)`` takes the arguments of the plain
``nbody_tpu_torch.ops.panel.sweep`` with the panel named by its
variant ("vpu", "mxu" or "mxu_c").  On CPU tensors it returns the plain
version; on CUDA tensors it validates the arguments, allocates the
output, launches the kernel on the current stream and raises if the
launch failed.  ``LAUNCHES`` counts launches per variant.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops.cuda import build
from nbody_tpu_torch.ops.cuda.launch import check, launched, on_cpu, stream
from nbody_tpu_torch.ops import panel as _plain

LAUNCHES = {f"panel_{v}": 0 for v in _plain.VARIANTS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sweep(variant: str, pos3: torch.Tensor, gx: torch.Tensor,
          gy: torch.Tensor, gz: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
    """Kernel version of panel.sweep(panel.PANELS[variant], ...)."""
    if variant not in _plain.VARIANTS:
        raise ValueError(f"unknown panel variant {variant!r}")
    if on_cpu(pos3, gx, gy, gz, gm):
        return _plain.sweep(_plain.PANELS[variant], pos3, gx, gy, gz, gm)
    f32 = torch.float32
    t = pos3.shape[0]
    g = gx.shape[0]
    if g % _plain.LC:
        raise ValueError(f"{g} sources are not a multiple of {_plain.LC}")
    out = torch.empty((t, _plain.B, 3), dtype=f32, device=pos3.device)
    srcs = [check(q, f32, (g,), name)
            for q, name in zip((gx, gy, gz, gm), ("gx", "gy", "gz", "gm"))]
    rc = build.load("panel").nbody_panel_sweep(
        _plain.VARIANTS.index(variant),
        check(pos3, f32, (t, _plain.B, 3), "pos3"), t, *srcs, g, _plain.SOFT,
        out.data_ptr(), stream(pos3))
    launched(rc, f"panel_{variant}", LAUNCHES)
    return out
