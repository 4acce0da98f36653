"""benchmark/program_spans.py on a synthetic Chrome trace with the
harness's ranges, the port's nbody.* spans, launch calls and device ops
joined by correlation id, and a planted offset of the device clock: the
four metrics read the hand-computed values, the labels of idle gaps by
the launch that ends them do not move with the offset (the labels by
the host's range at the gap's start do), the clock check reads the
offset, and every existing per-layer reader reads the same trace the
same with the program's spans in it as without; and run_spans reads
the counters around the harness's window, one start rebuild a segment."""

import itertools
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import torch

from benchmark import harness, program_spans, run_spans
from benchmark import trace_reader as tracing
from benchmark.tests import harness_copy
from nbody_tpu_torch.models.simulation import Simulation

READERS = Path(harness.__file__).with_name("layer_metrics")
STEPS = 2

# host ranges and spans: (name, start us, end us)
RANGES = [("traced_span", 1000, 11000), ("segment_restart", 1005, 9000),
          ("frame_sync", 9000, 9500)]
SPANS = [("nbody.run_scan", 1010, 8900),
         ("nbody.loop.load", 1020, 1100),
         ("nbody.rebuild", 1200, 3000),
         ("nbody.graph.rebuild", 1210, 1300),
         ("nbody.rebuild.horizon_read", 2000, 2900),
         ("nbody.graph.inner.farmid", 3100, 3200),
         ("nbody.graph.inner", 4100, 4150),
         ("nbody.loop.snapshot", 4600, 4800)]
# launch calls: (correlation, host time us, call name)
LAUNCHES = [(1, 1050, "cudaMemcpyAsync"), (2, 1250, "cudaGraphLaunch"),
            (3, 2010, "cudaMemcpyAsync"), (4, 3150, "cudaGraphLaunch"),
            (5, 4120, "cudaGraphLaunch"), (6, 4650, "cudaLaunchKernel"),
            (7, 12000, "cudaLaunchKernel")]       # after the traced span
# device ops on the host's clock: (correlation, cat, name, start, dur)
OPS = [(1, "gpu_memcpy", "Memcpy HtoD", 1060, 20),
       (2, "kernel", "void at::native::radixSortKVInPlace<int>(int)", 1300,
        400),
       (2, "kernel", "build_kernel(float*)", 1700, 800),
       (3, "gpu_memcpy", "Memcpy DtoH", 2500, 10),
       (4, "kernel", "void table_sweep_kernel<4>(float const*)", 3300, 300),
       (4, "kernel", "void near_span_kernel<4>(float const*)", 3600, 400),
       (5, "kernel", "void near_span_kernel<4>(float const*)", 4200, 300),
       (6, "kernel", "void at::native::elementwise_kernel<128>()", 4700, 20),
       (7, "kernel", "late_kernel()", 12010, 5)]


def events(offset=0.0, spans=True):
    """The trace's events, the device clock `offset` us from the host's."""
    out = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in RANGES + (SPANS if spans else [])]
    out += [{"cat": "cuda_runtime", "name": n, "ts": t, "dur": 5,
             "args": {"correlation": c}} for c, t, n in LAUNCHES]
    out += [{"cat": cat, "name": n, "ts": t + offset, "dur": d,
             "args": {"correlation": c}} for c, cat, n, t, d in OPS]
    return out


def program(offset=0.0):
    return program_spans.parse(events(offset), STEPS)


def test_the_four_metrics_read_the_hand_counts():
    p = program()
    # sort 400 + build 800 + the horizon's copy 10 us, one rebuild
    assert program_spans.rebuild_device_ms(p) == pytest.approx(1.21)
    # rebuild 90 + inner.farmid 100 + inner 50 us of graph launches
    assert program_spans.graphs_host_ms_per_step(p) == pytest.approx(0.12)
    # 2 kernels in the rebuild graph, 2 and 1 in the inner graphs
    assert program_spans.graphs_device_ops_per_step(p) == 2.5
    window = ({"rebuilds": 10, "start_rebuilds": 4},
              {"rebuilds": 26, "start_rebuilds": 12})
    assert program_spans.start_rebuild_pct(*window) == 50.0
    assert program_spans.metrics(p, window) == {
        "driver.start_rebuild_pct": 50.0,
        "rebuild.device_ms": pytest.approx(1.21),
        "graphs.host_ms_per_step": pytest.approx(0.12),
        "graphs.device_ops_per_step": 2.5}
    # each op's span; the late kernel was launched after the traced span
    assert [p.spans[op.span].name for op in p.ops] == [
        "nbody.loop.load", "nbody.graph.rebuild", "nbody.graph.rebuild",
        "nbody.rebuild.horizon_read", "nbody.graph.inner.farmid",
        "nbody.graph.inner.farmid", "nbody.graph.inner",
        "nbody.loop.snapshot"]
    assert [s.parent for s in p.spans] == [-1, 0, 0, 2, 2, 0, 0, 0]


def test_a_program_without_spans_reads_nothing():
    p = program_spans.parse(events(spans=False), STEPS)
    assert p.spans == [] and len(p.ops) == 8
    assert all(op.span == -1 for op in p.ops)
    assert program_spans.metrics(p, ({"rebuilds": 0}, {"rebuilds": 8})) == {}


def test_gap_labels_by_launch_do_not_move_with_the_clock():
    gaps = {}
    for off in (-40.0, 0.0, 40.0):
        p = program(off)
        gaps[off] = [(p.name(a), p.name(b), s) for a, b, s in p.gaps()]
    want = [("nbody.loop.load", "outside_spans", 60e-6),
            ("nbody.graph.rebuild", "nbody.loop.load", 220e-6),
            ("nbody.graph.inner.farmid", "nbody.rebuild.horizon_read",
             790e-6),
            ("nbody.graph.inner", "nbody.run_scan", 200e-6),
            ("nbody.loop.snapshot", "nbody.run_scan", 200e-6),
            ("span_end", "nbody.loop.snapshot", 6280e-6)]
    assert [g[:2] for g in gaps[0.0]] == [w[:2] for w in want]
    assert [g[2] for g in gaps[0.0]] == pytest.approx([w[2] for w in want])
    for off in (-40.0, 40.0):
        assert [g[0] for g in gaps[off]] == [w[0] for w in want]
        # the gaps between two ops are device times alone
        assert ([g[2] for g in gaps[off][1:-1]]
                == pytest.approx([g[2] for g in gaps[0.0][1:-1]]))
    # 40 us late, the host has left the load when the second gap starts
    assert gaps[40.0][1][1] == "nbody.run_scan"
    table = program_spans.idle_table(program())
    assert table["by_launch"]["nbody.graph.inner.farmid"] == {
        "gaps": 1, "ms": pytest.approx(0.79),
        "longest_ms": pytest.approx(0.79)}
    assert table["by_host_clock"]["nbody.run_scan"]["gaps"] == 2
    assert (sum(r["ms"] for r in table["by_launch"].values())
            == pytest.approx(sum(r["ms"] for r in
                                 table["by_host_clock"].values())))
    assert program_spans.longest_gaps(program(), 2) == [
        [pytest.approx(6.28), "span_end", "nbody.loop.snapshot#0"],
        [pytest.approx(0.79), "nbody.graph.inner.farmid#0",
         "nbody.rebuild.horizon_read#0"]]


def test_the_clock_check_reads_the_offset():
    # the memcpy starts 10 us after its launch, the least of all
    for off in (-40.0, 0.0, 40.0):
        clock = program(off).clock()
        assert clock["least_us"] == pytest.approx(10.0 + off)
        assert clock["least_span"] == "nbody.loop.load#0"
        # the next least leads are 50 us: 40 us behind, one op reads < 0
        assert clock["negative"] == {-40.0: 1, 0.0: 0, 40.0: 0}[off]
    assert program_spans.parse(events(), STEPS)._replace(ops=[]).clock() \
        is None


def _ctx(trace):
    return SimpleNamespace(
        cell=SimpleNamespace(traffic={"frame_steps": 16}), cfg=None,
        trace=trace, sweeps=harness.SWEEPS, window_steps=64,
        window_rebuilds=8,
        first_structure=lambda: {"serves": 2, "least": {
            "near_span": (1e-4, "flops"), "table_sweep": (5e-5, "bytes")}})


@pytest.mark.parametrize("reader", sorted(p.stem for p in
                                          READERS.glob("*.py")))
def test_existing_readers_read_the_same_with_program_spans(reader):
    mod = harness.load_module(READERS / f"{reader}.py",
                              "benchmark_metric_" + reader.replace(".", "_"))
    with_spans = tracing.parse(events(), STEPS)
    without = tracing.parse(events(spans=False), STEPS)
    assert with_spans == without
    got = mod.read(_ctx(with_spans))
    assert got is not None and got == mod.read(_ctx(without))
    assert with_spans.breakdown() == without.breakdown()


def test_run_spans_reads_a_start_rebuild_a_segment(tmp_path, monkeypatch):
    """The harness's window (harness_copy.small, on the CPU, the disk
    cell's start states in turn) under run_spans.watched: one start
    rebuild for each segment, from its own start state, however many
    frames (run_scan calls) the segment has; the harness's own functions
    are back afterwards.  The harness's clock is a counter, so the
    window is 8 frames, 4 segments."""
    root = harness_copy.small(tmp_path)
    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", SimpleNamespace(
        perf_counter=lambda: float(next(ticks)), sleep=time.sleep))
    loads = []
    run = Simulation.run

    def counted_run(self, state, *args, **kw):
        loads.append(state)
        return run(self, state, *args, **kw)

    window, span, read = (harness.run_window, harness.traced_span,
                          tracing.read)
    with run_spans.watched(harness, tracing) as seen:
        monkeypatch.setattr(Simulation, "run", counted_run)
        out = harness.run("v5_bench_1m.disk", 2**31 + 3, 8, False,
                          device=torch.device("cpu"), root=root)
    assert (harness.run_window, harness.traced_span, tracing.read) == (
        window, span, read)
    tr = harness.load_cell("v5_bench_1m.disk", root).traffic
    assert tr["start_states"] > 4
    segments = out["attempted"] * tr["frame_steps"] // tr["segment_steps"]
    assert out["attempted"] == 8 and segments == 4
    # the warm-up segment from state 0, then one segment a state
    assert len(loads) == 1 + segments and loads[0] is loads[1]
    assert len({id(x) for x in loads[1:]}) == segments
    before, after = seen["window"]
    starts = after["start_rebuilds"] - before["start_rebuilds"]
    assert starts == segments < out["attempted"]
    assert after["carried_calls"] - before["carried_calls"] == (
        out["attempted"] - segments)
    assert program_spans.start_rebuild_pct(before, after) == pytest.approx(
        100.0 * starts / (after["rebuilds"] - before["rebuilds"]))
