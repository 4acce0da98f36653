"""Morton (Z-order) codes as int64 keys.

Bit layout ``(X << 2) | (Y << 1) | Z`` of the v5 encoder
(nbody_v5.cu:57-78) at 10 bits per axis (30-bit codes) or 21 bits per
axis (63-bit codes, the legacy nbody_bh key width).  Both widths are one
int64 key per particle: a 63-bit code fits below the sign bit, so the
(hi, lo) uint32 pair the JAX package needs without x64 is unnecessary,
and ``key == (hi << 32) | lo`` of that pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Dilate the low 11 bits of `v`: bit i -> bit 3i (the reference's
    expandBits magic-number sequence, wrapped to 32 bits)."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def quantize(pos: torch.Tensor, lo: torch.Tensor, size: torch.Tensor,
             bits: int) -> torch.Tensor:
    """[N, 3] float32 positions -> [N, 3] int64 lattice coordinates in
    [0, 2^bits - 1].  Keeps the float32 operation order
    ``(pos - lo) / size * scale``, then clip, then truncate, so codes on
    a cell boundary match the JAX package's."""
    scale = float(2**bits - 1)
    q = (pos - lo) / size * scale
    q = torch.clamp(q, 0.0, scale)
    return q.to(torch.int64)


def encode30(pos: torch.Tensor, lo: torch.Tensor,
             size: torch.Tensor) -> torch.Tensor:
    """30-bit v5 codes [N] int64."""
    q = quantize(pos, lo, size, 10)
    return ((expand_bits(q[:, 0]) << 2) | (expand_bits(q[:, 1]) << 1)
            | expand_bits(q[:, 2]))


def _dilate21(v: torch.Tensor) -> torch.Tensor:
    """Dilate 21-bit `v` into 63 bits (low 11 bits -> 0..30, high 10
    bits -> 33..60)."""
    return expand_bits(v & 0x7FF) | (expand_bits(v >> 11) << 33)


def encode63(pos: torch.Tensor, lo: torch.Tensor,
             size: torch.Tensor) -> torch.Tensor:
    """63-bit codes [N] int64, same layout at 21 bits per axis."""
    q = quantize(pos, lo, size, 21)
    return ((_dilate21(q[:, 0]) << 2) | (_dilate21(q[:, 1]) << 1)
            | _dilate21(q[:, 2]))


def morton_sort(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort: (sorted codes, perm)."""
    sc, perm = torch.sort(codes, stable=True)
    return sc, perm
