"""The port's spans (utils/profiling.span) and run counters
(Simulation.counters) on the CPU, through the CPU stand-in for a CUDA
graph (torch_graph_standin.replayed) and a CPU torch.profiler session:
the nbody.* spans nest as the runners, loops and graphs call one another,
one nbody.rebuild span for each counted rebuild and one inner-step graph
span for each step, the start rebuilds count the run_scan calls that
the runner did not carry (the carried calls counted beside them), the
overflow counts of a build with a planted small near_cap equal
bh_diagnostics' flags graphed and eager, no record_function is entered
without a session, trajectories are the same traced and untraced, and
the command line prints the counters and traces the spans."""

import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import cli
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.models import ensemble as tens
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.utils import metrics

from torch_graph_standin import replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# test_torch_graphs.py's runner setup, with the kernels' wrappers (on CPU
# tensors they run the plain sweeps), so that the stand-in captures
BASE = dict(n=2048, force_tile=256, use_pallas=True, sup_cap=64,
            mid_cap=256, cmid_cap=512, near_cap=512, check_overflow=False)
PATHS = {
    "adaptive": dict(BASE, rebuild_every=8, hold_farmid=5,
                     farmid_span_rebuilds=True, span_age_mult=1, no_ss=True,
                     check_overflow=True),
    "per_step": dict(BASE, rebuild_every=1),
    "cycles": dict(BASE, rebuild_every=4, hold_farmid=2,
                   adaptive_rebuild=False),
}
CALLS = (6, 7)          # two run_scan calls; 8-step skins rebuild in both
# the span that encloses each nbody.* span (None: none does)
PARENT = {
    "nbody.run_scan": None,
    "nbody.check_overflow": "nbody.run_scan",
    "nbody.loop.load": "nbody.run_scan",
    "nbody.rebuild": "nbody.run_scan",
    "nbody.graph.rebuild": "nbody.rebuild",
    "nbody.rebuild.horizon_read": "nbody.rebuild",
    "nbody.graph.inner": "nbody.run_scan",
    "nbody.graph.inner.farmid": "nbody.run_scan",
    "nbody.graph.inner.refreshed": "nbody.run_scan",
    "nbody.loop.snapshot": "nbody.run_scan",
    "nbody.step": "nbody.run_scan",
    "nbody.graph.step": "nbody.step",
    "nbody.graph.cycle.4": "nbody.run_scan",
    "nbody.graph.cycle.2": "nbody.run_scan",
    "nbody.graph.cycle.3": "nbody.run_scan",
}


def _setup(path, **over):
    cfg = SimConfig(**dict(PATHS[path], **over))
    return cfg, make_initial_state(cfg, device="cpu")


def _traced(tmp_path, fn):
    """fn() inside one CPU profiler session: (its result, the nbody.*
    spans as (name, start, end, enclosing span's name) by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("nbody."))
    out_spans = []
    for ts, neg, name in spans:
        end = ts - neg
        holders = [s for s in out_spans if s[1] <= ts and end <= s[2]]
        out_spans.append((name, ts, end,
                          holders[-1][0] if holders else None))
    return out, out_spans


def _count(spans, prefix):
    return sum(1 for s in spans if s[0].startswith(prefix))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_as_the_layers_call(replayed, tmp_path, path):
    """Every nbody.* span lies inside the span of its caller: the rebuild
    graph and the horizon read inside nbody.rebuild, a step's graph
    inside nbody.step, the rest inside nbody.run_scan; each graph span
    once a replay."""
    cfg, ic = _setup(path)
    sim = tsim.Simulation(cfg, device="cpu")

    def calls():
        st = ic
        for n in CALLS:
            st = sim.run_scan(st, n)
        return st

    _, spans = _traced(tmp_path, calls)
    assert spans and all(parent == PARENT[name]
                         for name, _, _, parent in spans), spans
    assert _count(spans, "nbody.run_scan") == len(CALLS)
    graphs = _count(spans, "nbody.graph.")
    if path == "per_step":
        assert _count(spans, "nbody.step") == graphs == sum(CALLS)
    elif path == "cycles":
        # 6 = 4 + 2 and 7 = 4 + 3 steps: a cycle graph per cycle, the
        # loop loaded for the whole cycles and again for the remainder
        assert graphs == _count(spans, "nbody.graph.cycle.") == 4
        assert _count(spans, "nbody.loop.load") == 4
    else:
        assert _count(spans, "nbody.check_overflow") == 1
        assert _count(spans, "nbody.loop.snapshot") == len(CALLS)


def test_a_rebuild_span_per_rebuild_and_an_inner_span_per_step(replayed,
                                                               tmp_path):
    """One nbody.rebuild (with its graph and its horizon read) for each
    rebuild n_rebuilds counts, one nbody.graph.inner* for each step; the
    rebuild graph and each inner graph were captured and replayed."""
    cfg, ic = _setup("adaptive")
    sim = tsim.Simulation(cfg, device="cpu")
    sim.run_scan(ic, 13)            # captures every graph
    rb0 = sim.n_rebuilds
    _, spans = _traced(tmp_path, lambda: sim.run_scan(ic, 13))
    rebuilds = sim.n_rebuilds - rb0
    assert rebuilds >= 2
    for name in ("nbody.rebuild", "nbody.graph.rebuild",
                 "nbody.rebuild.horizon_read"):
        assert sum(1 for s in spans if s[0] == name) == rebuilds, name
    assert _count(spans, "nbody.graph.inner") == 13
    (loop,) = sim._loops.values()
    ran = {s[0] for s in spans}
    assert loop._rebuild_graph.graph is not None
    assert all(g.graph is not None for g in loop._steps.values()
               if g.span in ran)


def test_start_rebuilds_count_the_run_scan_calls(replayed):
    """A run_scan call on a state the runner did not hand out begins with
    a start rebuild; a call on the runner's own last output is carried
    and begins with none; the rest of n_rebuilds ran out a validity
    horizon; counters() reads the rebuilds, the start rebuilds and the
    carried calls, and an AdaptiveStepper's loop counts its constructor's
    rebuild as a start."""
    cfg, ic = _setup("adaptive")
    sim = tsim.Simulation(cfg, device="cpu")
    st = ic
    for n in (13, 3, 13):
        st = sim.run_scan(st, n)
        assert sim.n_start_rebuilds == 1
    assert sim.counters()["carried_calls"] == 2
    for i in (2, 3):                    # from the IC: no carry
        sim.run_scan(ic, 3)
        assert sim.n_start_rebuilds == i
    c = sim.counters()
    assert c["rebuilds"] == sim.n_rebuilds > c["start_rebuilds"] == 3
    assert c["carried_calls"] == 2
    assert c["builds"] == c["rebuilds"]
    stepper = sim.make_stepper(ic)
    stepper.advance(13)
    assert stepper._loop.start_rebuilds == 1
    assert stepper._loop.builds == stepper.n_rebuilds >= 2


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("path", ["adaptive", "cycles"])
def test_overflow_counts_equal_bh_diagnostics(request, path, graphed):
    """A near_cap of 16 overflows the near band of every build and no
    other list (bh_diagnostics' flags at the start and the end state).
    The cycles keep the cap: counters() counts every build overflowed,
    by its near flag alone.  The adaptive loop grows the cap past the
    demand at its first build and redoes it: counters() counts that build
    overflowed, by its near flag alone, and redone, and no later build
    overflows.  The same through the graphs (the warm-up's and the
    capture's additions taken back out) as eagerly."""
    if graphed:
        request.getfixturevalue("replayed")
    cfg, ic = _setup(path, near_cap=16)
    sim = tsim.Simulation(cfg, device="cpu")
    st = sim.run_scan(sim.run_scan(ic, 13), 5)
    want, end = ({f: d["cell_overflow" if f == "cells" else f"{f}_overflow"]
                  for f in tsim.BUILD_FLAGS}
                 for d in (metrics.bh_diagnostics(x, cfg) for x in (ic, st)))
    assert want == end and want["near"] and sum(want.values()) == 1
    c = sim.counters()
    assert c["builds"] >= 4
    if path == "cycles":
        assert c["overflowed_builds"] == c["builds"]
    else:
        assert c["overflowed_builds"] == c["builds_redone"] == 1
        assert c["builds"] == c["rebuilds"] + 1
        assert c["cap_growths"] >= 1
        assert c["caps"]["near"] > c["demand_max"]["near"] > 16
    assert c["overflow_by_flag"] == {f: c["overflowed_builds"] * v
                                     for f, v in want.items()}
    (loop,) = (sim._loops or sim._cycles).values()
    graphs = ([loop._rebuild_graph] if path == "adaptive"
              else list(loop._cycles.values()))
    assert all((g.graph is not None) == graphed for g in graphs)


def test_no_record_function_without_a_session(replayed, monkeypatch,
                                              tmp_path):
    """With no profiler session active the spans enter no
    record_function on any path (the adaptive loop, the per-step graph,
    the cycles, the ensemble); inside one they enter nbody.* ranges
    only."""
    entered = []
    real = autograd_profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(autograd_profiler, "record_function", Counted)

    def every_path():
        for path in PATHS:
            cfg, ic = _setup(path, n=1024)
            tsim.Simulation(cfg, device="cpu").run_scan(ic, 5)
        cfg, ic = _setup("per_step", n=1024)
        batched = tens.stack_states([ic, ic])
        tens.make_ensemble_step(cfg)(batched)

    every_path()
    assert entered == []
    _traced(tmp_path, every_path)
    assert entered and all(n.startswith("nbody.") for n in entered)
    assert "nbody.graph.ensemble" in entered


def test_trajectories_are_the_same_traced_and_untraced(replayed, tmp_path):
    """run_scan through the graphs gives the state of the eager runner
    bit for bit, with a profiler session open and without, and the
    counters do not depend on the session."""
    cfg, ic = _setup("adaptive")
    eager = tsim.make_adaptive_runner(cfg, 13, graphs=False)(ic)
    sims = [tsim.Simulation(cfg, device="cpu") for _ in range(2)]
    plain = sims[0].run_scan(ic, 13)
    traced, _ = _traced(tmp_path, lambda: sims[1].run_scan(ic, 13))
    assert _same(plain, eager) and _same(traced, eager)
    assert sims[0].counters() == sims[1].counters()


def test_cli_run_prints_the_counters(capsys):
    """`run` prints the counters beside the kernel launches: the
    rebuilds split into start (step 0's run_scan call alone: each logged
    chunk goes on from the last one's state) and horizon rebuilds, the
    carried calls, and the builds' overflow counts."""
    assert cli.main(["run", "--preset", "v5", "--n", "3000", "--steps", "9",
                     "--log-every", "4", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    line = [l for l in err.splitlines() if l.startswith("counters: ")]
    assert len(line) == 1
    c = json.loads(line[0][len("counters: "):])
    # step 0 is a run_scan call of one step on the adaptive runner; then
    # run_scan calls of 4 and 4 steps, each on the last call's output
    assert c["start_rebuilds"] == 1
    assert c["carried_calls"] == 2
    assert c["rebuilds"] == c["start_rebuilds"] + c["horizon_rebuilds"]
    assert c["builds"] == c["rebuilds"]
    assert c["step_builds"] == 0
    assert set(c["overflow_by_flag"]) == set(tsim.BUILD_FLAGS)
    assert c["overflowed_builds"] == c["builds_redone"] == 0
    assert c["cap_growths"] == 0
    assert set(c["caps"]) == set(c["demand_max"]) == set(tsim.DEMANDS)
    assert all(c["demand_max"][k] <= c["caps"][k] for k in tsim.DEMANDS)


def test_cli_bench_trace_holds_the_program_spans(tmp_path, capsys):
    """`bench --trace DIR`'s trace holds the step's spans."""
    assert cli.main(["bench", "--n", "1024", "--frames", "1", "--device",
                     "cpu", "--trace", str(tmp_path / "tr")]) == 0
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"nbody.step", "nbody.graph.step"} <= names
