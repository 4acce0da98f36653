"""The port's own spans in the torch.profiler trace of the harness's
traced span, and what they measure.

While a profiler session is active the port opens a range named
``nbody.*`` at the boundaries of its runners, loops and graphs
(nbody_tpu_torch/utils/profiling.span): ``nbody.run_scan``,
``nbody.loop.load``, ``nbody.rebuild`` (holding ``nbody.graph.rebuild``
and ``nbody.rebuild.horizon_read``), ``nbody.graph.<name>`` around each
graph's replay, ``nbody.step``, ``nbody.loop.snapshot`` and
``nbody.check_overflow``.  A device op (kernel, memcpy or memset) whose
launch lies inside the traced span is joined to its launch call by
correlation id, as trace_reader.parse joins it, and belongs to the
innermost ``nbody.*`` span that holds that launch: a graph's kernels
carry the correlation id of their ``cudaGraphLaunch``, so they belong
to the replay's ``nbody.graph.<name>``.

An idle gap (a stretch of the traced span that no device interval
covers) is labelled two ways: by the span that holds the launch of the
op that ends it, two host times, so the label does not depend on how
the device clock lies against the host's; and as trace_reader labels
it, by the span the host was in at the gap's start, a device time.
`Program.clock` gives what the second rule rests on: device start less
host launch time over the span's ops, which cannot be negative on one
clock.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from benchmark import trace_reader as tracing

PREFIX = "nbody."
GRAPH = "nbody.graph."
REBUILD = "nbody.rebuild"
OUTSIDE, END = -1, -2   # no span holds the time; the last gap: no op ends it
LABELS = {OUTSIDE: "outside_spans", END: "span_end"}


class Span(NamedTuple):
    name: str
    ts: float           # host start, microseconds
    end: float
    parent: int         # the enclosing span's index, -1 for none


class Gap(NamedTuple):
    by_launch: int      # the span holding the launch of the op ending it
    by_host: int        # the span holding the gap's start on the host
    seconds: float


class Op(NamedTuple):
    name: str           # trace_reader.short_name
    ts: float           # device start, microseconds
    dur: float
    launch: float       # host time of the launch call, microseconds
    span: int           # the innermost span holding the launch, or -1


class Program(NamedTuple):
    spans: List[Span]   # by start
    ops: List[Op]       # by device start
    lo: float           # the traced span's host range, microseconds
    hi: float
    steps: int

    def under(self, i: int, match: Callable[[str], bool]) -> bool:
        """Whether span `i` or a span enclosing it has a name `match`
        accepts."""
        while i >= 0:
            if match(self.spans[i].name):
                return True
            i = self.spans[i].parent
        return False

    def ops_under(self, match: Callable[[str], bool]) -> List[Op]:
        """The device ops launched inside a span whose name `match`
        accepts."""
        return [op for op in self.ops if self.under(op.span, match)]

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for s in self.spans if match(s.name))

    def host_s(self, match: Callable[[str], bool]) -> float:
        """Host seconds inside the spans `match` accepts (which do not
        nest in one another)."""
        return sum(s.end - s.ts for s in self.spans if match(s.name)) / 1e6

    def gaps(self) -> List[Gap]:
        """Every idle stretch of the traced span, with the two spans that
        label it (indices, or OUTSIDE / END)."""
        starts = [s.ts for s in self.spans]
        out, t = [], self.lo
        for op in self.ops:
            if op.ts > t:
                out.append(Gap(op.span, _innermost(self.spans, starts, t),
                               (op.ts - t) / 1e6))
            t = max(t, op.ts + op.dur)
        if self.hi > t:
            out.append(Gap(END, _innermost(self.spans, starts, t),
                           (self.hi - t) / 1e6))
        return out

    def name(self, i: int) -> str:
        """Span `i`'s name, or the label of OUTSIDE or END."""
        return self.spans[i].name if i >= 0 else LABELS[i]

    def nth(self, i: int) -> str:
        """Span `i`'s name and its rank among the spans of that name
        (`nbody.rebuild#0` is the traced span's first rebuild)."""
        if i < 0:
            return LABELS[i]
        name = self.spans[i].name
        return f"{name}#{sum(1 for s in self.spans[:i] if s.name == name)}"

    def clock(self) -> Optional[dict]:
        """Device start less host launch time over the ops, in
        microseconds: the least (and its op and span), the median and
        how many ops read below zero."""
        if not self.ops:
            return None
        d = [op.ts - op.launch for op in self.ops]
        least = min(range(len(d)), key=d.__getitem__)
        return {"least_us": d[least], "least_op": self.ops[least].name,
                "least_span": self.nth(self.ops[least].span),
                "median_us": statistics.median(d),
                "negative": sum(1 for x in d if x < 0)}


def _innermost(spans: List[Span], starts: List[float], t: float) -> int:
    """The index of the innermost span holding host time `t`, or -1.
    Spans nest, so it encloses (or is) the last span to start by t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and spans[i].end < t:
        i = spans[i].parent
    return i


def parse(events: List[dict], steps: int) -> Program:
    """The traced span's nbody.* spans and device ops from a trace's
    events (trace_reader.SPAN marks the span, as for trace_reader)."""
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    span = [e for e in ann if e.get("name") == tracing.SPAN]
    if len(span) != 1:
        raise ValueError(f"the trace holds {len(span)} '{tracing.SPAN}' "
                         "ranges")
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])
    raw = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in ann
                  if e.get("name", "").startswith(PREFIX)
                  and lo <= float(e["ts"]) <= hi))
    spans: List[Span] = []
    stack: List[int] = []
    for ts, neg_dur, name in raw:
        while stack and spans[stack[-1]].end < ts:
            stack.pop()
        spans.append(Span(name, ts, ts - neg_dur, stack[-1] if stack else -1))
        stack.append(len(spans) - 1)
    starts = [s.ts for s in spans]
    launched_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        if e.get("cat") not in tracing.DEVICE_CATS:
            continue
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if t is not None and lo <= t <= hi:
            ops.append(Op(tracing.short_name(e), float(e["ts"]),
                          float(e["dur"]), t, _innermost(spans, starts, t)))
    ops.sort(key=lambda op: op.ts)
    return Program(spans=spans, ops=ops, lo=lo, hi=hi, steps=steps)


def idle_table(program: Program) -> Dict[str, Dict[str, dict]]:
    """Idle time by span under each rule ("by_launch", "by_host_clock"):
    for each label the gaps' count, their sum and the longest, in ms."""
    out: Dict[str, Dict[str, dict]] = {"by_launch": {}, "by_host_clock": {}}
    for by_launch, by_host, s in program.gaps():
        for rule, i in (("by_launch", by_launch), ("by_host_clock", by_host)):
            row = out[rule].setdefault(program.name(i), {
                "gaps": 0, "ms": 0.0, "longest_ms": 0.0})
            row["gaps"] += 1
            row["ms"] += 1e3 * s
            row["longest_ms"] = max(row["longest_ms"], 1e3 * s)
    return out


def longest_gaps(program: Program, top: int = 10) -> List[list]:
    """The `top` longest gaps: [ms, span by launch, span by host clock],
    each span with its rank among those of its name (Program.nth)."""
    gaps = sorted(program.gaps(), key=lambda g: -g.seconds)[:top]
    return [[1e3 * g.seconds, program.nth(g.by_launch),
             program.nth(g.by_host)] for g in gaps]


def is_graph(name: str) -> bool:
    return name.startswith(GRAPH)


def is_rebuild(name: str) -> bool:
    return name == REBUILD


def rebuild_device_ms(program: Program) -> Optional[float]:
    """rebuild.device_ms: device ms of the ops launched inside the
    nbody.rebuild spans of the traced span, over those spans."""
    n = program.count(is_rebuild)
    if n == 0:
        return None
    return sum(op.dur for op in program.ops_under(is_rebuild)) / 1e3 / n


def graphs_host_ms_per_step(program: Program) -> Optional[float]:
    """graphs.host_ms_per_step: host wall ms inside the nbody.graph.*
    spans of the traced span, over its steps."""
    if program.count(is_graph) == 0 or program.steps <= 0:
        return None
    return 1e3 * program.host_s(is_graph) / program.steps


def graphs_device_ops_per_step(program: Program) -> Optional[float]:
    """graphs.device_ops_per_step: kernels, memcpys and memsets launched
    inside the nbody.graph.* spans, over the traced span's steps."""
    if program.count(is_graph) == 0 or program.steps <= 0:
        return None
    return len(program.ops_under(is_graph)) / program.steps


def start_rebuild_pct(before: dict, after: dict) -> Optional[float]:
    """driver.start_rebuild_pct: 100 x the start rebuilds over all the
    rebuilds between two readings of Simulation.counters() (None when
    the program counts no start rebuilds, or none happened)."""
    if "start_rebuilds" not in before or "start_rebuilds" not in after:
        return None
    rebuilds = after["rebuilds"] - before["rebuilds"]
    if rebuilds <= 0:
        return None
    return 100.0 * (after["start_rebuilds"]
                    - before["start_rebuilds"]) / rebuilds


def metrics(program: Program, window: Tuple[dict, dict]) -> Dict[str, float]:
    """The four metrics by name, from the traced span's program and the
    counters read around the window; those with nothing to read left
    out."""
    got = {"driver.start_rebuild_pct": start_rebuild_pct(*window),
           "rebuild.device_ms": rebuild_device_ms(program),
           "graphs.host_ms_per_step": graphs_host_ms_per_step(program),
           "graphs.device_ops_per_step": graphs_device_ops_per_step(program)}
    return {k: v for k, v in got.items() if v is not None}
