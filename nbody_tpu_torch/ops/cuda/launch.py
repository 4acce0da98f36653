"""What every kernel wrapper does around a launch: pick the plain version
for CPU tensors, validate arguments, name the stream, check the launch's
return code and count it."""

from __future__ import annotations

from typing import Dict

import torch


def on_cpu(*xs: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises otherwise."""
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({x.device for x in xs}) != 1:
        raise ValueError(f"tensors must all lie on one CUDA device (or all "
                         f"on the CPU), got {sorted(str(x.device) for x in xs)}")
    return False


def check(x: torch.Tensor, dtype: torch.dtype, shape, name: str) -> int:
    """Validate one kernel argument and return its data pointer."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return x.data_ptr()


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launched(rc: int, name: str, counts: Dict[str, int]) -> None:
    """Raise if the launch failed (the C entry point returns
    cudaGetLastError()), else count it."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    counts[name] += 1
