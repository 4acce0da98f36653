"""What every kernel wrapper does around a launch: pick the plain version
for CPU tensors, validate arguments, name the stream, check the launch's
return code and count it.

The counts are plain integers that a wrapper adds to where it launches
its kernel.  A kernel launched from a CUDA graph is not launched from
Python: a capture calls the wrapper without running the kernel, and a
replay runs it without calling the wrapper.  So every count is
registered here (``counter``): a capture runs inside ``uncounted``, which
takes its launches back out and records them, and each replay ``add``s
that record, so a reader sees the launches that ran.  ``reset`` zeroes
every registered count and ``counts`` reads them all in one dict, so no
reader has to know which module launches which kernel.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch

_COUNTERS: List[Dict[str, int]] = []

# what a block of launches added to each registered count
Launches = List[Tuple[Dict[str, int], Dict[str, int]]]


def counter(*names: str) -> Dict[str, int]:
    """A registered launch count per kernel name, all at zero."""
    counts = dict.fromkeys(names, 0)
    _COUNTERS.append(counts)
    return counts


def reset() -> None:
    """Set every registered count to zero."""
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


def counts() -> Dict[str, int]:
    """Every registered count, by kernel name."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


@contextlib.contextmanager
def uncounted() -> Iterator[Launches]:
    """Launches counted inside the block are taken back out of every
    count when it ends.  Yields a list that then holds, per registered
    count, what the block added to it.  A count registered inside the
    block (its wrapper's module first imported there, as a lazy import
    in a graph's warm-up is) started at zero."""
    before = [(c, dict(c)) for c in _COUNTERS]
    made: Launches = []
    try:
        yield made
    finally:
        before += [(c, dict.fromkeys(c, 0)) for c in _COUNTERS[len(before):]]
        for c, b in before:
            made.append((c, {k: c[k] - b.get(k, 0) for k in c}))
            c.update(b)


def add(made: Launches) -> None:
    """Count once more what a block recorded by `uncounted` launched."""
    for c, d in made:
        for k, v in d.items():
            c[k] += v


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
