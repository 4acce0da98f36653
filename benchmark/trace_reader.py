"""Reading one torch.profiler trace of the harness's traced span.

Device work (kernels, memcpy and memset events) belongs to the span when
the host call that launched it lies inside the span's range: a kernel
launched through ctypes has no aten op, and a graph's kernels carry the
correlation id of the graph's launch (the method of chip_smoke.py's
profile_spans).  Busy time is the union of the span's device intervals;
an idle gap is a stretch of the span that no device interval covers,
labelled by the innermost harness range (segment_restart, frame,
frame_sync) that the host was in when it began.
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Tuple

SPAN = "traced_span"
RANGES = ("segment_restart", "frame", "frame_sync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Op(NamedTuple):
    name: str       # the kernel's short name, or the copy's kind
    ts: float       # device start, microseconds
    dur: float      # microseconds


def short_name(event: dict) -> str:
    """A kernel's bare function name (no namespace, template arguments or
    parameters); a memcpy or memset event's category and name."""
    if event.get("cat") != "kernel":
        return f"{event['cat']} {event.get('name', '')}".strip()
    name = event["name"].replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split(" ")[-1][-60:]


class Trace(NamedTuple):
    ops: List[Op]                          # device work of the span, by ts
    ranges: List[Tuple[str, float, float]]  # harness ranges (name, ts, end)
    lo: float                              # the span's host range, us
    hi: float
    steps: int

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the ops' device intervals, merged, in order."""
        merged: List[List[float]] = []
        for op in self.ops:
            a, b = op.ts, op.ts + op.dur
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def device_s(self, exclude=()) -> float:
        """Device seconds of every op whose name is not in `exclude`."""
        return sum(op.dur for op in self.ops if op.name not in exclude) / 1e6

    def durations(self, name: str) -> List[float]:
        """Seconds of each launch of the kernel `name`, in launch order."""
        return [op.dur / 1e6 for op in self.ops if op.name == name]

    def _label(self, t: float) -> str:
        inner = None
        for name, a, b in self.ranges:
            if a <= t <= b and (inner is None or a >= inner[1]):
                inner = (name, a)
        return inner[0] if inner else "outside_ranges"

    def gaps(self) -> List[Tuple[str, float]]:
        """(label, seconds) of every idle stretch of the span."""
        out, t = [], self.lo
        for a, b in self.intervals():
            if a > t:
                out.append((self._label(t), (a - t) / 1e6))
            t = max(t, b)
        if self.hi > t:
            out.append((self._label(t), (self.hi - t) / 1e6))
        return out

    def breakdown(self) -> dict:
        """The device ops with the most time, by name, and the longest
        idle gaps, each list at most TOP long."""
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
        gaps = sorted(self.gaps(), key=lambda g: g[1], reverse=True)
        return {"device_ops": [[k, v] for k, v in ops[:TOP]],
                "idle_gaps": [[k, v] for k, v in gaps[:TOP]]}


def parse(events: List[dict], steps: int) -> Trace:
    """The span's device work and harness ranges from a trace's events."""
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    span = [e for e in ann if e.get("name") == SPAN]
    if len(span) != 1:
        raise ValueError(f"the trace holds {len(span)} '{SPAN}' ranges")
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])
    launched_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if t is not None and lo <= t <= hi:
            ops.append(Op(short_name(e), float(e["ts"]), float(e["dur"])))
    ops.sort(key=lambda op: op.ts)
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in ann if e.get("name") in RANGES
              and lo <= float(e["ts"]) <= hi]
    return Trace(ops=ops, ranges=ranges, lo=lo, hi=hi, steps=steps)


def read(path: str, steps: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return parse(events, steps)
