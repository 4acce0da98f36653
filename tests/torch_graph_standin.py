"""A CPU stand-in for capturing and replaying a CUDA graph
(utils/graphs.Graphed), shared by the tests of the port's graphed paths:
the `replayed` fixture makes every Graphed capture through it, so the
CPU runs the code that the card replays and counts launches as a
replay counts them."""

import weakref

import pytest
import torch

from nbody_tpu_torch.ops import forces as tforces
from nbody_tpu_torch.ops.cuda import classify, forces as kern, tables
from nbody_tpu_torch.ops.cuda import launch
from nbody_tpu_torch.utils import graphs


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _Replay:
    """A CUDA graph's CPU stand-in: a replay runs the function again, its
    launches uncounted (the graph's record adds them), and writes its
    outputs into the captured ones in place.  It holds its Graphed
    weakly, as a CUDA graph holds nothing of it."""

    def __init__(self, g):
        self.g = weakref.ref(g)

    def replay(self):
        g = self.g()
        with launch.uncounted():
            out = g.run()
        _copy_into(g.out, out)


def _record(self):
    """A capture's CPU stand-in: the function run once and its buffers put
    back, since a capture runs nothing."""
    saved = [b.clone() for b in self.buffers]
    out = self.run()
    for b, s in zip(self.buffers, saved):
        b.copy_(s)
    return _Replay(self), out


@pytest.fixture
def replayed(monkeypatch):
    """Every Graphed captures through the stand-ins, and the plain sweeps,
    the plain classifier and the plain table build count a launch per
    call as their kernels' wrappers do."""
    monkeypatch.setattr(graphs, "capturable", lambda device: True)
    monkeypatch.setattr(graphs.Graphed, "_warm_up", lambda self: self.run())
    monkeypatch.setattr(graphs.Graphed, "_record", _record)
    for attr, counts, name in (
            ("far_sweep_torch", kern.LAUNCHES, "far_sweep"),
            ("table_sweep_torch", kern.LAUNCHES, "table_sweep"),
            ("near_correction_torch", kern.LAUNCHES, "near_span"),
            ("cell_band_lists_torch", classify.LAUNCHES, "band_classify"),
            ("build_cell_tables_torch", tables.LAUNCHES, "table_build")):
        def counted(*a, _plain=getattr(tforces, attr), _counts=counts,
                    _name=name, **kw):
            _counts[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tforces, attr, counted)


def _never(self):
    """A warm-up or a record that fails the test: patched in where no
    capture may be entered."""
    raise AssertionError("entered a capture")
