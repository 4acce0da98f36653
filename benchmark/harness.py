"""One run of one cell of the port's benchmark: the cell's files found by
name, its inputs made from the seed, a warm-up segment, the measured
window, the check of the window's frames against the plain reference,
and with tracing one profiled span read by the per-layer readers.

The window drives the command line's batch path,
``Simulation.run(state, S, callback, callback_every=F)``: a segment of S
steps from the cell's start state in frames of F steps, each frame a
``run_scan`` call ending in a device sync.  When a segment ends the next
starts again from the same start state, so every version of the program
does the same work a segment.  The window ends at the first frame
boundary past the run's seconds (after one whole segment at least).  The
same Simulation serves the warm-up and every segment, so each graph is
captured in set-up and only replayed in the window.

A cell's pieces, each found by the name that BENCHMARK.json gives:
  configs/<config>.json   the SimConfig fields as run, with source,
                          assumed, reduced, precision and deployment
  traffic/<mix>.json      the start state's generator and parameters,
                          segment_steps, frame_steps, trace_steps,
                          check_frames, check_bodies
  ics/<generator>.py      make(n, seed, g, device, **params)
  limits/<cell>.json      each number `correct` compares, with its limit
  layer_metrics/<m>.py    read(ctx): one per-layer metric, or None
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from benchmark import trace_reader as tracing
from benchmark.reference import check

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")
SWEEPS = ("far_sweep_kernel", "table_sweep_kernel", "near_span_kernel")
META_KEYS = ("source", "assumed", "reduced", "precision", "deployment")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_module(path: Path, name: str):
    """The Python file at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(SimpleNamespace):
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metric entries."""


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in spec["end_to_end"]
                  if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"], root=root,
                config=_read_json(root / conf["file"]),
                traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(bench / "limits" / f"{name}.json"),
                per_layer=per_layer, end_to_end=end_to_end)


def sim_config(cell: Cell, device: torch.device):
    """The cell's SimConfig; off CUDA the kernels' plain versions."""
    from nbody_tpu_torch.config import SimConfig

    fields = {k: v for k, v in cell.config.items() if k not in META_KEYS}
    cfg = SimConfig(**fields)
    if device.type != "cuda":
        cfg = cfg.replace(use_pallas=False)
    return cfg


def physics(cfg) -> check.Physics:
    soft = cfg.softening ** 2 if cfg.legacy_softening else cfg.softening
    return check.Physics(g=cfg.g, soft=soft, dt=cfg.dt,
                         max_speed=cfg.max_speed)


def start_state(cell: Cell, cfg, seed: int, device: torch.device):
    """The cell's start state from the seed, on `device`."""
    from nbody_tpu_torch.state import ParticleState

    tr = cell.traffic
    gen = load_module(cell.root / "benchmark" / "ics" / f"{tr['ic']}.py",
                      f"benchmark_ic_{tr['ic']}")
    pos, vel, mass = gen.make(cfg.n, seed, cfg.g, device=device,
                              **tr.get("ic_params", {}))
    return ParticleState.create(pos, vel, mass, device=device)


class _WindowClosed(Exception):
    pass


class Window:
    """The frames of the measured window: their end times, the states the
    check reads, and the rebuilds the runner counted."""

    def __init__(self, seed: int, check_frames: int):
        self.rng = random.Random(seed)
        self.keep = max(1, check_frames)
        self.ends: List[float] = []
        self.checked: list = []       # (frame index, start, end)
        self.seen = 0                 # frames after the first
        self.first_segment_end = None
        self.steps = 0
        self.t0 = 0.0                 # the window's start
        self.rebuilds = 0

    def frame(self, i: int, start, end) -> None:
        """Keep the first frame (it starts from the cell's start state)
        and a reservoir sample of the others, drawn from the seed."""
        if i == 0:
            self.checked.append((i, start, end))
            return
        self.seen += 1
        if len(self.checked) < self.keep:
            self.checked.append((i, start, end))
        else:
            r = self.rng.randrange(self.seen)
            if r < self.keep - 1:
                self.checked[1 + r] = (i, start, end)


def run_window(sim, start, cell: Cell, seed: int, seconds: float) -> Window:
    tr = cell.traffic
    seg, fr = tr["segment_steps"], tr["frame_steps"]
    win = Window(seed, tr["check_frames"])
    prev = [start]

    def on_frame(done: int, state) -> None:
        t = time.perf_counter()
        i = len(win.ends)
        win.ends.append(t)
        win.steps += fr
        win.frame(i, prev[0], state)
        prev[0] = state
        if done == seg and win.first_segment_end is None:
            win.first_segment_end = state
        if t - t0 >= seconds and win.first_segment_end is not None:
            raise _WindowClosed

    rb0 = sim.n_rebuilds
    t0 = time.perf_counter()
    win.t0 = t0
    try:
        while True:
            prev[0] = start
            sim.run(start, seg, on_frame, callback_every=fr)
    except _WindowClosed:
        pass
    win.rebuilds = sim.n_rebuilds - rb0
    return win


def frame_stats(win: Window) -> Dict[str, float]:
    times = [1e3 * (b - a) for a, b in zip([win.t0] + win.ends, win.ends)]
    q = statistics.quantiles(times, n=20)
    return {"frames": len(times), "frame_ms_p50": statistics.median(times),
            "frame_ms_p95": q[18],
            "steps_per_s": win.steps / (win.ends[-1] - win.t0)}


def sample_rows(n: int, k: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:min(k, n)].to(device)


def as_frame(start, end, steps: int) -> check.Frame:
    return check.Frame(pos_a=start.pos, vel_a=start.vel, pos_b=end.pos,
                       vel_b=end.vel, acc_b=end.acc, mass=end.mass,
                       steps=steps)


def check_window(win: Window, cell: Cell, cfg, seed: int, device,
                 control: bool = False) -> dict:
    """The readings of every checked frame, their worst, and
    force_err_p50 at the end of the first whole segment."""
    phys = physics(cfg)
    tr = cell.traffic
    rows = sample_rows(cfg.n, tr["check_bodies"], seed, device)
    per_frame = []
    for i, a, b in win.checked:
        r = check.frame_readings(as_frame(a, b, tr["frame_steps"]), rows,
                                 phys, control=control)
        per_frame.append(r)
        log(f"frame {i} ({'control' if control else 'program'}): "
            + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
    seg_end = win.first_segment_end
    force_p50 = check.force_error(
        as_frame(seg_end, seg_end, tr["frame_steps"]), rows, phys)
    return {"numbers": check.worst(per_frame), "per_frame": per_frame,
            "force_err_p50": force_p50}


def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def first_structure(cfg, state) -> dict:
    """The band structure that a segment's first launches sweep, its work
    (benchmark/work.py) and how many near_span launches sweep it: the
    adaptive runner's first rebuild (skins for K steps), which serves
    min(s_valid, F) steps of a frame; for a per-step rebuild (K <= 1)
    the unskinned build of the start state, which serves one step.  The
    structure is the port's own (its sort, rebuild and band build), so a
    change there changes the rooflines' yardstick too."""
    from nbody_tpu_torch.ops import forces
    from nbody_tpu_torch.tools import common

    from benchmark import work

    if cfg.adaptive_rebuild and cfg.rebuild_every > 1:
        rebuild, args = common.first_rebuild(state, cfg)
        (ps, *_), (_, ss, bands, tables, _), (s_valid, _) = rebuild(*args)
        serves = int(s_valid)
    else:
        ps, ms, cs, *_ = common.sorted_padded(state, cfg)
        _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
        serves = 1
    w = work.work(cfg.force_tile, cfg.near_cap, ps, ss, bands, tables)
    return {"work": w, "least": work.least_seconds(w), "serves": serves}


def traced_span(sim, start, cell: Cell) -> tracing.Trace:
    """One torch.profiler session over the first trace_steps steps of a
    segment, after every graph has been captured."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = cell.traffic
    fr, steps = tr["frame_steps"], tr["trace_steps"]
    dev = start.pos.device
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a short first span has come back without its kernels
        x = torch.zeros(1, device=dev)
        for _ in range(200):
            x += 1
        torch.cuda.synchronize(dev)
        time.sleep(0.2)
        with record_function(tracing.SPAN):
            state = start
            for f in range(steps // fr):
                with record_function("segment_restart" if f == 0
                                     else "frame"):
                    state = sim.run_scan(state, fr)
                with record_function("frame_sync"):
                    torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return tracing.read(path, steps)


def per_layer(cell: Cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        path = cell.root / "benchmark" / "layer_metrics" / f"{m['name']}.py"
        reader = load_module(path, "benchmark_metric_"
                             + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: Optional[torch.device] = None, t_start: Optional[float] = None,
        root: Path = ROOT) -> dict:
    """One run; returns the result line's object.  `device` None is the
    chip, which has to hold the cell's cards."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the benchmark runs on the "
                               "card only")
        if torch.cuda.device_count() < cell.chips:
            raise RuntimeError(f"{workload} needs {cell.chips} cards, "
                               f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    on_cuda = device.type == "cuda"
    from nbody_tpu_torch.models.simulation import Simulation

    cfg = sim_config(cell, device)
    tr = cell.traffic
    log(f"{workload}: n={cfg.n} K={cfg.rebuild_every} R={cfg.hold_farmid} "
        f"tile={cfg.force_tile} S={tr['segment_steps']} "
        f"F={tr['frame_steps']} seed={seed} seconds={seconds} trace={trace}")
    sim = Simulation(cfg, device=device)
    start = start_state(cell, cfg, seed, device)
    # the warm-up segment: the overflow probe, the kernel library and
    # every graph the window replays
    sim.run(start, tr["segment_steps"], lambda *_: None,
            callback_every=tr["frame_steps"])
    if on_cuda:
        torch.cuda.synchronize(device)
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"forbidden modules loaded in set-up: {bad}")
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    win = run_window(sim, start, cell, seed, seconds)
    if on_cuda:
        torch.cuda.synchronize(device)
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"forbidden modules loaded in the window: {bad}")
    fs = frame_stats(win)
    log(f"window: {fs['frames']} frames, {win.steps} steps, "
        f"{win.rebuilds} rebuilds; steps/s {fs['steps_per_s']:.6g}; frame "
        f"ms p50 {fs['frame_ms_p50']:.6g} p95 {fs['frame_ms_p95']:.6g}")
    dev_info = {"platform": "gpu" if on_cuda else "cpu",
                "kind": (torch.cuda.get_device_name(device) if on_cuda
                         else "cpu"),
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_reserved(device)
                                      if on_cuda else 0)}
    if on_cuda:
        dev_info["memory_allocated_peak_bytes"] = (
            torch.cuda.max_memory_allocated(device))
        dev_info["power_limit_w"] = power_limit_w()
    log(f"device: {json.dumps(dev_info)}")

    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        tspan = traced_span(sim, start, cell)
        dev_info["busy_s"] = tspan.busy_s
        dev_info["window_s"] = tspan.window_s
        memo: dict = {}

        def first():
            if not memo:
                memo.update(first_structure(cfg, start))
                log(f"first structure: serves {memo['serves']} steps; least "
                    "ms " + ", ".join(f"{k} {1e3 * t:.4g} ({b})" for k, (t, b)
                                      in memo["least"].items()))
            return memo

        ctx = SimpleNamespace(
            cell=cell, cfg=cfg, trace=tspan, sweeps=SWEEPS,
            window_steps=win.steps, window_rebuilds=win.rebuilds,
            first_structure=first)
        metrics = per_layer(cell, ctx)
        breakdown = tspan.breakdown()
        log(f"traced span: {tspan.steps} steps, busy {tspan.busy_s:.6g} s "
            f"of {tspan.window_s:.6g} s")
    del sim
    if on_cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    chk = check_window(win, cell, cfg, seed, device)
    correct, checks = check.judge(chk["numbers"], cell.limits)
    log(f"check: {time.perf_counter() - t_check:.1f} s; force_err_p50 at "
        f"the first segment's end {chk['force_err_p50']:.6g}%")
    if not trace:
        # steps_per_s.host_paced is steps_per_s under the wider bound of
        # the cells whose steps the host paces
        e2e = {"steps_per_s": (fs["steps_per_s"], "steps/s"),
               "steps_per_s.host_paced": (fs["steps_per_s"], "steps/s"),
               "force_err_p50": (chk["force_err_p50"], "%"),
               "setup_s": (setup_s, "s")}
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": e2e[m["name"]][1]}
                   for m in cell.end_to_end}
    failed = sum(any(not r[k] <= lim for k, lim in cell.limits.items())
                 for r in chk["per_frame"])
    out = {"correct": correct, "attempted": fs["frames"], "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
