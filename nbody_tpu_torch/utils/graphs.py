"""CUDA graphs for the runner's fixed-shape work: the port's counterpart
of wrapping a step in ``jax.jit`` and keeping the compiled program.

A rebuild or a step launches thousands of small kernels, and launching
each from Python costs more host time than most of them take on the
card.  ``Graphed`` captures such a function once as a CUDA graph
(``torch.cuda.graphs``) and replays it: one launch from the host for the
whole function.  On the CPU it calls the function, through the same
buffers, so the CPU tests run the code that the card replays.
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional, Sequence

import torch

from nbody_tpu_torch.ops.cuda import launch
from nbody_tpu_torch.utils.profiling import span


def capturable(device: torch.device) -> bool:
    """Whether work on `device` runs as captured graphs: CUDA only."""
    return device.type == "cuda"


class Graphed:
    """`fn(*args)` captured once as a CUDA graph and replayed, on CUDA;
    called directly on any other device or when `capture` is False.

    `fn` is a bound method of the graph's owner, held weakly: the owner
    holds the graph, and owner, graph and memory pool go with the owner's
    last reference, not at a later cycle collection.  It reads tensors
    that outlive it (the owner's static buffers, or another graph's live
    outputs) and writes its results back into them in place; what it
    returns are its live outputs, tensors that every replay overwrites in
    place.  Every scalar it reads from the host, `args` included, is
    baked into the graph at capture, so a value that changes between
    calls must live in a device buffer.

    The first call warms `fn` up on a side stream (the kernel libraries
    load and every op's lazy set-up runs outside the capture, as
    ``torch.cuda.graphs`` asks), puts `buffers` (every tensor `fn` writes
    in place) back as they were, captures, and replays: the first replay
    computes the first result.  A capture that fails raises, and so does
    a synchronizing operation inside it; nothing falls back to eager.
    The launch counts of ``ops/cuda/launch`` see what ran on the card:
    the warm-up's and the capture's launches are taken back out, and
    every replay adds the capture's.

    Graphs that share a memory `pool` must replay one at a time on one
    stream, and none may keep a result in a temporary of another: each
    keeps its results in the owner's buffers or in its own live
    outputs.

    Every launch, a replay or an eager call, is the span
    ``nbody.graph.<name>`` (utils/profiling.span)."""

    def __init__(self, fn: Callable, buffers: Sequence[torch.Tensor],
                 device: torch.device, name: str, capture: bool = True,
                 pool: Optional[tuple] = None, args: tuple = ()):
        self._fn = weakref.WeakMethod(fn)
        self.span = f"nbody.graph.{name}"
        self.args = args
        self.buffers = tuple(buffers)
        self.device = torch.device(device)
        self.captures = capture and capturable(self.device)
        self.pool = pool
        self.graph = None
        self.out = None
        self.launches: launch.Launches = []

    def run(self):
        """fn(*args), eagerly."""
        return self._fn()(*self.args)

    def __call__(self):
        if self.captures and self.graph is None:
            self._capture()
        with span(self.span):
            if not self.captures:
                return self.run()
            self.graph.replay()
        launch.add(self.launches)
        return self.out

    def _capture(self) -> None:
        saved = [b.clone() for b in self.buffers]
        with launch.uncounted():
            self._warm_up()
            for b, s in zip(self.buffers, saved):
                b.copy_(s)
            del saved
            with launch.uncounted() as self.launches:
                self.graph, self.out = self._record()

    def _warm_up(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.run()
        current.wait_stream(side)

    def _record(self):
        """(the captured graph, fn's live outputs).  Sync debug mode
        raises on a synchronizing call inside the capture."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.run()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return graph, out
