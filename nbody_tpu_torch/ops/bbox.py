"""Cubified axis-aligned bounding box (nbody_v5.cu:158-180 semantics)."""

from __future__ import annotations

from typing import Tuple

import torch


def bounding_cube(pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo [3], size []) of the cubified AABB of `pos` [N, 3]; `size` is
    the largest axis extent, clamped to >= 1 like the Morton kernel."""
    lo = pos.amin(dim=0)
    hi = pos.amax(dim=0)
    size = torch.clamp((hi - lo).amax(), min=1.0)
    return lo, size
