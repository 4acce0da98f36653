"""One traced run of a cell, read a second time through the port's own
spans and counters.

    python3 benchmark/run_spans.py --workload <cell> --seed <n>
        --seconds <s>

The run is benchmark/run.py's with --trace 1, unchanged: the same
set-up, window, traced span, check and result line.  Around the harness's
window and its traced span this script reads Simulation.counters() (a
program without it gives n_rebuilds alone), outside the timed window;
the traced span's exported trace is read a second time by
benchmark/program_spans.py.  Standard error ends with the counters and a
table of idle ms by program span under both labelling rules; standard
output ends with run.py's line, then one line more: {"program": {...}}
with the four metrics of program_spans.metrics, the counters, the idle
table, the clock check and the traced span's wall and busy ms a step.
A program without nbody.* spans reads empty tables and no span metrics.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def counters(sim) -> dict:
    read = getattr(sim, "counters", None)
    return read() if read is not None else {"rebuilds": sim.n_rebuilds}


@contextlib.contextmanager
def watched(harness, tracing):
    """The harness's window, traced span and trace reading, each wrapped
    to keep what the program view needs in the dict this yields; the
    harness's own functions are put back on leaving."""
    seen: dict = {}
    window, span, read = harness.run_window, harness.traced_span, tracing.read

    def run_window(sim, *args, **kw):
        before = counters(sim)
        win = window(sim, *args, **kw)
        seen["window"] = (before, counters(sim))
        return win

    def traced_span(sim, *args, **kw):
        before = counters(sim)
        got = span(sim, *args, **kw)
        seen["traced"] = (before, counters(sim))
        return got

    def read_trace(path, steps):
        with open(path) as f:
            seen["events"] = json.load(f)["traceEvents"]
        seen["trace"] = tracing.parse(seen["events"], steps)
        return seen["trace"]

    harness.run_window, harness.traced_span = run_window, traced_span
    tracing.read = read_trace
    try:
        yield seen
    finally:
        harness.run_window, harness.traced_span = window, span
        tracing.read = read


def view(seen: dict) -> dict:
    from benchmark import program_spans

    trace = seen["trace"]
    prog = program_spans.parse(seen["events"], trace.steps)
    return {"metrics": program_spans.metrics(prog, seen["window"]),
            "counters": {k: list(v) for k, v in seen.items()
                         if k in ("window", "traced")},
            "idle_ms": program_spans.idle_table(prog),
            "longest_gaps": program_spans.longest_gaps(prog),
            "clock": prog.clock(),
            "spans": {name: prog.count(name.__eq__)
                      for name in sorted({s.name for s in prog.spans})},
            "traced_ms_per_step": 1e3 * trace.window_s / trace.steps,
            "busy_ms_per_step": 1e3 * trace.busy_s / trace.steps}


def log(v: dict) -> None:
    def say(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    for k, (a, b) in v["counters"].items():
        say(f"counters around the {k}: {json.dumps(a)} -> {json.dumps(b)}")
    say(f"program spans: {json.dumps(v['spans'])}; clock: "
        f"{json.dumps(v['clock'])}; traced ms a step "
        f"{v['traced_ms_per_step']:.6g}, busy {v['busy_ms_per_step']:.6g}")
    for rule, rows in v["idle_ms"].items():
        say(f"idle ms by program span, {rule}:")
        for label, r in sorted(rows.items(), key=lambda kv: -kv[1]["ms"]):
            say(f"  {label:<28} {r['gaps']:6d} gaps {r['ms']:10.4f} ms, "
                f"longest {r['longest_ms']:.4f}")
    say("longest gaps (ms, span by launch, span by host clock): "
        + "; ".join(f"{ms:.4f} {a} {b}" for ms, a, b in v["longest_gaps"]))
    say(f"program metrics: {json.dumps(v['metrics'])}")


def main(argv=None) -> int:
    # the repository root, in place of this script's folder
    sys.path[0] = str(ROOT)
    from benchmark import harness, run
    from benchmark import trace_reader as tracing

    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    with watched(harness, tracing) as seen:
        rc = run.main(argv)
    if rc == 0:
        v = view(seen)
        log(v)
        print(json.dumps({"program": v}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
