"""The adaptive runner carried across run_scan calls (models/simulation.py,
_AdaptiveLoop.carries / carry) on the CPU: a chain of calls on the
runner's own outputs equals one call of all their steps bit for bit,
eagerly and through the CPU stand-in for a CUDA graph, at caps that grow
in the first call too; Simulation.run's frames are that chain's states;
a copy, a state changed in place, another Simulation's output or an
older output starts again exactly as a fresh Simulation does; the
counters split the calls into start rebuilds and carried calls; the loop
holds no state of the caller's alive; the fixed-K cycles and the
per-step rebuild never carry."""

import gc
import weakref

import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.state import ParticleState

from torch_graph_standin import replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# test_torch_runner.py's runner setups at n = 2048: the held far+mid
# spanning rebuilds (its age and k_env both carried), a plain hold of 4,
# and refresh_moments (a refresh that is not a rebuild's first step)
BASE = dict(n=2048, force_tile=256, use_pallas=False, sup_cap=64,
            mid_cap=256, cmid_cap=512, near_cap=512, check_overflow=False)
CASES = {
    "span_age1_no_ss": dict(BASE, rebuild_every=8, hold_farmid=5,
                            farmid_span_rebuilds=True, span_age_mult=1,
                            no_ss=True),
    "hold4": dict(BASE, rebuild_every=16, hold_farmid=4),
    "refresh_moments": dict(BASE, rebuild_every=8, hold_farmid=4,
                            refresh_moments=True),
}
SPAN = "span_age1_no_ss"
TOTAL = 13


def _setup(case=SPAN, **over):
    cfg = SimConfig(**dict(CASES[case], **over))
    return cfg, make_initial_state(cfg, device="cpu")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _copy(state):
    return ParticleState(*(x.clone() for x in state))


def _chain(sim, state, splits):
    """run_scan over `splits`, each call on the last one's output: (the
    states after each call, the rebuilds each call counted)."""
    states, rebuilds = [], []
    for k in splits:
        rb0 = sim.n_rebuilds
        state = sim.run_scan(state, k)
        states.append(state)
        rebuilds.append(sim.n_rebuilds - rb0)
    return states, rebuilds


@pytest.fixture(scope="module")
def whole():
    """One 13-step run_scan call of each case from its IC: (ic, the state
    after, its rebuilds)."""
    out = {}
    for case in CASES:
        cfg, ic = _setup(case)
        sim = tsim.Simulation(cfg, device="cpu")
        out[case] = (ic, sim.run_scan(ic, TOTAL), sim.n_rebuilds)
    return out


@pytest.mark.parametrize("case,splits", [
    (SPAN, (6, 7)), (SPAN, (1, 12)), (SPAN, (5, 1, 3, 4)),
    ("hold4", (6, 7)), ("refresh_moments", (3, 3, 7))])
def test_a_chain_equals_one_call(whole, case, splits):
    """run_scan on its own outputs equals one call of all their steps bit
    for bit, and the calls' rebuilds sum to the one call's: only the
    first call starts with a rebuild, every later one is carried."""
    cfg, _ = _setup(case)
    ic, want, want_rb = whole[case]
    sim = tsim.Simulation(cfg, device="cpu")
    states, rebuilds = _chain(sim, ic, splits)
    assert _same(states[-1], want)
    assert sum(rebuilds) == sim.n_rebuilds == want_rb
    assert want_rb >= (2 if case == SPAN else 1)
    c = sim.counters()
    assert (c["start_rebuilds"], c["carried_calls"]) == (1, len(splits) - 1)
    assert c["rebuilds"] == c["builds"] == want_rb


def test_make_adaptive_runner_carries_its_own_output(whole):
    """The runner function that make_adaptive_runner returns carries as
    run_scan does: a chain of its calls equals one call, and return_stats
    counts each call's rebuilds only."""
    cfg, _ = _setup()
    ic, want, want_rb = whole[SPAN]
    run = tsim.make_adaptive_runner(cfg, 1, return_stats=True)
    st, rebuilds = ic, []
    for _ in range(TOTAL):
        st, n_rb = run(st)
        rebuilds.append(n_rb)
    assert _same(st, want)
    assert sum(rebuilds) == want_rb and rebuilds[0] == 1
    assert set(rebuilds) <= {0, 1}


def test_chain_through_the_graph_standin_equals_one_eager_call(replayed,
                                                               whole):
    """Through the CPU stand-in for the captured graphs (the hand
    kernels' wrappers, plain on CPU tensors): a chain of run_scan calls
    replays the graphs the first call captured and gives one eager call's
    state bit for bit."""
    cfg, _ = _setup(use_pallas=True)
    ic, want, _ = whole[SPAN]
    sim = tsim.Simulation(cfg, device="cpu")
    states, _ = _chain(sim, ic, (4, 4, 5))
    (loop,) = sim._loops.values()
    assert loop._rebuild_graph.graph is not None
    assert _same(states[-1], want)
    assert sim.counters()["carried_calls"] == 2


def test_run_frames_are_the_chains_states(whole):
    """Simulation.run(..., callback_every=F) hands its callback the states
    of a chain of F-step run_scan calls (the last one shorter), and ends
    at one call's state: the schedule does not depend on how often the
    host looks."""
    cfg, _ = _setup()
    ic, want, want_rb = whole[SPAN]
    sim = tsim.Simulation(cfg, device="cpu")
    seen = []
    out = sim.run(ic, TOTAL, lambda done, s: seen.append((done, s)),
                  callback_every=4)
    chain, _ = _chain(tsim.Simulation(cfg, device="cpu"), ic, (4, 4, 4, 1))
    assert [d for d, _ in seen] == [4, 8, 12, 13]
    assert all(_same(s, c) for (_, s), c in zip(seen, chain))
    assert _same(out, want) and sim.n_rebuilds == want_rb
    assert sim.counters()["carried_calls"] == 3


def _restarts(case, first, sim, other):
    """The state that each restart case hands the second call, from the
    first call's output `first` (sim's) and `other`, another
    Simulation's output of the same steps."""
    if case == "copy":
        return _copy(first)
    if case == "changed_in_place":
        first.vel.mul_(1.0)         # same values, a write all the same
        return first
    if case == "field_replaced":
        return first._replace(acc=first.acc.clone())
    if case == "other_simulation":
        return other
    # an older output: the loop has handed out another state since
    sim.run_scan(first, 2)
    return first


@pytest.mark.parametrize("case", ["copy", "changed_in_place",
                                  "field_replaced", "other_simulation",
                                  "older_output"])
def test_any_other_state_starts_again(case):
    """A copy of the runner's output, that output changed in place (as a
    callback may change it), with one field replaced, another
    Simulation's output, or an output older than the last: the call
    starts again, equal to a fresh Simulation's call on that state bit
    for bit, and counts a start rebuild and no carried call."""
    cfg, ic = _setup()
    sim = tsim.Simulation(cfg, device="cpu")
    first = sim.run_scan(ic, 6)
    other = tsim.Simulation(cfg, device="cpu").run_scan(ic, 6)
    st = _restarts(case, first, sim, other)
    c0 = sim.counters()
    got = sim.run_scan(st, 7)
    c = sim.counters()
    assert (c["start_rebuilds"] - c0["start_rebuilds"],
            c["carried_calls"] - c0["carried_calls"]) == (1, 0)
    assert _same(got, tsim.Simulation(cfg, device="cpu").run_scan(
        _copy(st), 7))
    carried = tsim.Simulation(cfg, device="cpu")
    assert not _same(got, carried.run_scan(carried.run_scan(ic, 6), 7))


def test_a_callback_that_writes_the_state_restarts_the_next_frame():
    """Simulation.run with a callback that changes the state in place:
    every frame after it starts again, as a chain of run_scan calls on
    copies of the changed states does."""
    cfg, ic = _setup()

    def kick(done, s):
        s.vel.mul_(1.001)

    sim = tsim.Simulation(cfg, device="cpu")
    out = sim.run(ic, 12, kick, callback_every=4)
    ref, st = tsim.Simulation(cfg, device="cpu"), ic
    for _ in range(3):
        st = ref.run_scan(st, 4)
        kick(0, st)
        st = _copy(st)
    assert _same(out, st)
    c = sim.counters()
    assert (c["start_rebuilds"], c["carried_calls"]) == (3, 0)


def test_the_loop_holds_no_caller_state_alive():
    """The loop remembers its last output by weak reference: once the
    caller drops it, its tensors are freed."""
    cfg, ic = _setup()
    sim = tsim.Simulation(cfg, device="cpu")
    out = sim.run_scan(ic, 2)
    refs = [weakref.ref(x) for x in (out.pos, out.vel, out.acc)]
    del out
    gc.collect()
    assert [r() for r in refs] == [None] * 3
    sim.run_scan(ic, 2)
    assert sim.counters()["carried_calls"] == 0


@pytest.mark.parametrize("path", ["cycles", "per_step"])
def test_cycles_and_per_step_never_carry(path):
    """The fixed-K cycles and the per-step rebuild start every call as
    before: a chain on their own outputs equals a chain on copies."""
    over = (dict(adaptive_rebuild=False, rebuild_every=4, hold_farmid=2,
                 farmid_span_rebuilds=False, span_age_mult=0)
            if path == "cycles" else dict(rebuild_every=1))
    cfg, ic = _setup(**over)
    sim = tsim.Simulation(cfg, device="cpu")
    got = sim.run_scan(sim.run_scan(ic, 6), 3)
    ref = tsim.Simulation(cfg, device="cpu")
    assert _same(got, ref.run_scan(_copy(ref.run_scan(ic, 6)), 3))
    c = sim.counters()
    assert c["carried_calls"] == c["start_rebuilds"] == 0


def test_caps_grown_in_one_call_carry_into_the_next():
    """A near_cap of 16 overflows the first build: the loop grows it and
    redoes the build in the first call; the carried calls go on at the
    grown caps and equal one call, with one redone build in all."""
    cfg, ic = _setup(near_cap=16)
    one = tsim.Simulation(cfg, device="cpu")
    want = one.run_scan(ic, 9)
    sim = tsim.Simulation(cfg, device="cpu")
    states, _ = _chain(sim, ic, (3, 6))
    assert _same(states[-1], want)
    c, w = sim.counters(), one.counters()
    assert c["builds_redone"] == w["builds_redone"] == 1
    assert c["caps"] == w["caps"] and c["caps"]["near"] > 16
    assert c["carried_calls"] == 1
