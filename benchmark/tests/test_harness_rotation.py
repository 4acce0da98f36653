"""The window's start states (harness.start_states, run_window), on the
CPU at a size a test run holds (harness_copy.small): one start state
gives the frames and states of a window whose every segment restarts
from the one start state, bit for bit; with M states segment j starts
from state j mod M and runs from it; state 0 is the seed's own state;
the states are reproducible from the seed and distinct; and states 1 to
M-1 are made after set-up is timed.  The window's clock is a counter:
frame k of the window ends at k "seconds", so a window of 8 seconds is 8
frames, whatever the CPU's speed."""

import itertools
import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.tests import harness_copy
from nbody_tpu_torch.models.simulation import Simulation

CPU = torch.device("cpu")
CELL = "v5_bench_1m.disk"
SEED = 2**31 + 29


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return harness_copy.small(tmp_path_factory.mktemp("bench"))


def _cell(root, states):
    """The small disk cell with `states` start states."""
    cell = harness.load_cell(CELL, root)
    cell.traffic = dict(cell.traffic, start_states=states)
    return cell


@pytest.fixture
def counted_clock(monkeypatch):
    """harness's clock as a counter: each read one second later."""
    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", SimpleNamespace(
        perf_counter=lambda: float(next(ticks)), sleep=time.sleep))


@pytest.fixture
def frames(monkeypatch):
    """Every (start, end) state that the window hands Window.frame."""
    seen = []
    frame = harness.Window.frame

    def record(self, i, start, end):
        assert i == len(seen)
        seen.append((start, end))
        frame(self, i, start, end)

    monkeypatch.setattr(harness.Window, "frame", record)
    return seen


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _one_state_window(sim, start, tr, n_frames):
    """The window as it was with one start state: every segment from the
    same `start`, its frames chained, for n_frames frames."""
    out, prev = [], [start]

    def on_frame(done, state):
        out.append((prev[0], state))
        prev[0] = state

    while len(out) < n_frames:
        prev[0] = start
        sim.run(start, tr["segment_steps"], on_frame,
                callback_every=tr["frame_steps"])
    return out[:n_frames]


def test_one_start_state_is_the_window_as_it_was(root, counted_clock,
                                                 frames):
    cell = _cell(root, 1)
    tr = cell.traffic
    cfg = harness.sim_config(cell, CPU)
    starts = harness.start_states(cell, cfg, SEED, CPU)
    assert len(starts) == 1
    win = harness.run_window(Simulation(cfg, device=CPU), starts, cell,
                             SEED, 8)
    per_seg = tr["segment_steps"] // tr["frame_steps"]
    assert len(win.ends) == len(frames) == 8 and 8 // per_seg >= 2
    want = _one_state_window(Simulation(cfg, device=CPU), starts[0], tr, 8)
    for (a, b), (wa, wb) in zip(frames, want):
        assert _equal(a, wa) and _equal(b, wb)
    assert frames[0][0] is starts[0]
    assert _equal(win.first_segment_end, want[per_seg - 1][1])
    assert win.steps == 8 * tr["frame_steps"]
    assert win.by_state[0][0] == 8 // per_seg
    assert win.by_state[0][1] == win.rebuilds > 0


def test_segment_j_starts_from_state_j_mod_m(root, counted_clock, frames):
    cell = _cell(root, 3)
    tr = cell.traffic
    cfg = harness.sim_config(cell, CPU)
    starts = harness.start_states(cell, cfg, SEED, CPU)
    assert len(starts) == 3
    win = harness.run_window(Simulation(cfg, device=CPU), starts, cell,
                             SEED, 8)
    per_seg = tr["segment_steps"] // tr["frame_steps"]
    segments = len(frames) // per_seg
    assert len(frames) == 8 and segments == 4
    ref = Simulation(cfg, device=CPU)
    for j in range(segments):
        first = j * per_seg
        assert frames[first][0] is starts[j % 3]
        # the segment ran from its own state: its first frame is F steps
        # of a fresh run from that state
        want = ref.run_scan(starts[j % 3], tr["frame_steps"])
        assert _equal(frames[first][1], want)
        for k in range(first + 1, first + per_seg):
            assert frames[k][0] is frames[k - 1][1]
    assert [n for n, _ in win.by_state] == [2, 1, 1]
    assert sum(r for _, r in win.by_state) == win.rebuilds
    # the check's first frame and the segment's end stay on state 0
    assert win.checked[0][1] is starts[0]
    assert win.first_segment_end is frames[per_seg - 1][1]


def test_state_zero_is_the_seeds_state(root):
    cell = _cell(root, 3)
    cfg = harness.sim_config(cell, CPU)
    assert harness.state_seeds(cell.traffic, SEED)[0] == SEED
    one = harness.start_state(cell, cfg, SEED, CPU)
    assert _equal(harness.start_states(cell, cfg, SEED, CPU)[0], one)
    # a mix that names no start_states has the seed's state alone
    plain = harness.load_cell("bh_100k_k1.disk", root).traffic
    assert "start_states" not in plain
    assert harness.state_seeds(plain, SEED) == [SEED]


@pytest.mark.parametrize("seed", [7, SEED, 2**33 + 1])
def test_states_are_reproducible_and_distinct(root, seed):
    cell = _cell(root, 4)
    cfg = harness.sim_config(cell, CPU)
    seeds = harness.state_seeds(cell.traffic, seed)
    assert seeds == harness.state_seeds(cell.traffic, seed)
    assert len(set(seeds)) == 4 and seeds[0] == seed
    assert all(0 <= s < 2**31 for s in seeds[1:])
    a = harness.start_states(cell, cfg, seed, CPU)
    b = harness.start_states(cell, cfg, seed, CPU)
    assert all(_equal(x, y) for x, y in zip(a, b))
    for x, y in itertools.combinations(a, 2):
        assert not torch.equal(x.pos, y.pos)
    assert len({x.pos.shape for x in a}) == 1


def test_later_states_are_made_after_setup_is_timed(tmp_path, monkeypatch):
    root = harness_copy.small(tmp_path)
    traffic = root / "benchmark" / "traffic" / "disk_s64_f16.json"
    traffic.write_text(json.dumps(dict(json.loads(traffic.read_text()),
                                       start_states=3)))
    events = []
    make, say = harness.start_state, harness.log

    def start_state(cell, cfg, seed, device):
        events.append(("state", seed))
        return make(cell, cfg, seed, device)

    def log(msg):
        events.append(("log", msg.split(" ")[0].rstrip(":")))
        say(msg)

    monkeypatch.setattr(harness, "start_state", start_state)
    monkeypatch.setattr(harness, "log", log)
    out = harness.run(CELL, SEED, 0.1, False, device=CPU, root=root)
    assert out["correct"] is True
    seeds = harness.state_seeds({"start_states": 3}, SEED)
    made = [e for e in events if e[0] == "state"]
    assert made == [("state", s) for s in seeds]
    setup = events.index(("log", "set-up"))
    window = events.index(("log", "window"))
    assert events.index(("state", seeds[0])) < setup
    assert all(setup < events.index(("state", s)) < window
               for s in seeds[1:])
