"""The port's captured dispatch (utils/graphs.Graphed, the adaptive loop's
buffers and the Simulation's caches) on the CPU, where nothing is
captured: the tensor prediction time against the float one and against
nbody_tpu, run_scan through a reused loop against fresh Simulations and
nbody_tpu's runner, the cache at two body counts, the launch counts
under replay (a CPU stand-in for a CUDA graph that replays by running
the function again) as chip_smoke.py's runner check and the bench's
far-sweep counter read them, and that no CPU run, plain sweep, rope
walk or sharded loop enters a capture (the CPU stand-in is in
torch_graph_standin.py; the direct step, the fixed-K cycles and the
ensemble are tested in test_torch_graphs_paths.py)."""

import dataclasses
import gc
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_jax
from nbody_tpu.models import simulation as jsim

from nbody_tpu_torch import bench
from nbody_tpu_torch.convert import config_from_dict, state_from_numpy
from nbody_tpu_torch.models import ensemble as tens
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops.cuda import forces as kern
from nbody_tpu_torch.ops.cuda import launch
from nbody_tpu_torch.parallel import comm, shard
from nbody_tpu_torch.utils import graphs, metrics

from torch_graph_standin import _never, replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# tests/test_torch_runner.py's runner setups (its BASE caps)
BASE = dict(n=2048, force_tile=256, use_pallas=False, sup_cap=64,
            mid_cap=256, cmid_cap=512, near_cap=512, check_overflow=False)
CASES = {
    "hold4": dict(BASE, rebuild_every=16, hold_farmid=4),
    "span_age1_no_ss": dict(BASE, rebuild_every=8, hold_farmid=5,
                            farmid_span_rebuilds=True, span_age_mult=1,
                            no_ss=True),
    "refresh_moments": dict(BASE, rebuild_every=16, hold_farmid=4,
                            refresh_moments=True),
}
# tests/test_torch_runner.py's trajectory tolerance against nbody_tpu: the
# port sums each sweep's float32 terms in float64, the JAX package in
# float32 (~1e-4 in position over 13 steps of dt 0.02 at ~1e3)
TRAJ = dict(rtol=1e-5, atol=1e-3)
STEPS = (6, 7)          # two run_scan calls, 13 steps in all


def _pair(**kw):
    jc = JConfig(**kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _tstate(js):
    return state_from_numpy(*(np.asarray(x) for x in js))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _copy(state):
    """A copy of `state`, which an adaptive runner never carries."""
    return type(state)(*(x.clone() for x in state))


# --- the prediction time as a device scalar ----------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hold_predict_pos_tensor_tau_bit_equal(mode):
    """The loop's 0-d float64 tau gives the float tau's positions bit for
    bit (0.5 tau^2 in float64 both ways) and nbody_tpu's within its
    float32 rounding (rtol 1e-6, test_torch_runner's bound)."""
    rng = np.random.default_rng(10 + mode)
    p, v, a = (rng.normal(0, s, (500, 3)).astype(np.float32)
               for s in (1000.0, 300.0, 5000.0))
    jc, tc = _pair(n=500, hold_predict=mode)
    tp, tv, ta = (torch.from_numpy(x) for x in (p, v, a))
    for r_eff in (1, 2, 5, 8):
        tau = 0.5 * (r_eff - 1) * tc.dt
        want = tsim.hold_predict_pos(tp, tv, ta, tau, tc)
        got = tsim.hold_predict_pos(
            tp, tv, ta, torch.full((), tau, dtype=torch.float64), tc)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        ref = jsim.hold_predict_pos(*(jnp.asarray(x) for x in (p, v, a)), tau,
                                    jc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


# --- run_scan through the cache ----------------------------------------------


@pytest.fixture(scope="module", params=sorted(CASES))
def two_calls(request):
    """nbody_tpu's runner in two calls (6 and 7 steps) from one IC."""
    jc, tc = _pair(**CASES[request.param])
    st = disk_galaxy_jax(jc.n, seed=7, g=jc.g)
    outs = [st]
    for k in STEPS:
        run = jax.jit(jsim.make_adaptive_runner(jc, k, return_stats=True))
        outs.append(run(outs[-1])[0])
    return dict(tc=tc, ic=_tstate(st), jax=outs[1:])


def test_run_scan_reuses_its_loop_and_matches_fresh_and_jax(two_calls):
    """Two run_scan calls on one Simulation (the second on the first's
    loop, its buffers reloaded from a copy of the first's output, so that
    it starts again as nbody_tpu's runner does) equal two calls on fresh
    Simulations bit for bit, and nbody_tpu's runner within TRAJ; a third
    call from the first call's state (no longer the loop's last output)
    repeats the second."""
    tc, ic = two_calls["tc"], two_calls["ic"]
    sim = tsim.Simulation(tc, device="cpu")
    got = [sim.run_scan(ic, STEPS[0])]
    loop = next(iter(sim._loops.values()))
    got.append(sim.run_scan(_copy(got[0]), STEPS[1]))
    assert list(sim._loops.values()) == [loop]
    fresh = [tsim.Simulation(tc, device="cpu").run_scan(ic, STEPS[0])]
    fresh.append(tsim.Simulation(tc, device="cpu").run_scan(fresh[0],
                                                            STEPS[1]))
    for g, f, j in zip(got, fresh, two_calls["jax"]):
        assert _same(g, f)
        np.testing.assert_allclose(g.pos.numpy(), np.asarray(j.pos), **TRAJ)
        np.testing.assert_allclose(g.vel.numpy(), np.asarray(j.vel), **TRAJ)
    assert _same(sim.run_scan(got[0], STEPS[1]), got[1])
    moved = (got[1].pos - ic.pos).norm(dim=1)
    assert float(moved.median()) > 0.5


def test_cache_serves_two_body_counts():
    """One Simulation at n = 1000 and 1800 (two padded row counts) and
    1010 (1000's rows): every adaptive call and per-step rebuild equals a
    fresh Simulation's, one loop per row count, one step per n."""
    _, tc = _pair(**dict(BASE, rebuild_every=8, hold_farmid=2))
    sim = tsim.Simulation(tc, device="cpu")
    for n in (1000, 1800, 1010, 1000):
        st = _tstate(disk_galaxy_jax(n, seed=n, g=tc.g))
        fresh = tsim.Simulation(tc, device="cpu")
        assert _same(sim.run_scan(st, 5), fresh.run_scan(st, 5))
    assert sorted(k[1] for k in sim._loops) == [1024, 2048]
    k1 = tsim.Simulation(tc.replace(rebuild_every=1), device="cpu")
    for n in (1000, 1800, 1000):
        st = _tstate(disk_galaxy_jax(n, seed=n, g=tc.g))
        assert _same(k1.run_scan(st, 2), tsim.step_barnes_hut(
            tsim.step_barnes_hut(st, k1.cfg), k1.cfg))
    assert sorted(k[1] for k in k1._steps) == [1000, 1800]


# --- launch counts under replay -----------------------------------------------


def test_uncounted_takes_a_block_out_and_add_replays_it():
    counts = launch.counter("a", "b")
    try:
        counts["a"] = 5
        with launch.uncounted():                 # warm-up and capture
            counts["a"] += 3
            with launch.uncounted() as made:     # the capture
                counts["a"] += 2
                counts["b"] += 1
            assert counts == {"a": 8, "b": 0}
        assert counts == {"a": 5, "b": 0}
        for _ in range(3):                       # three replays
            launch.add(made)
        assert counts == {"a": 11, "b": 3}
        assert [d for c, d in made if c is counts] == [{"a": 2, "b": 1}]
        assert any(c is kern.LAUNCHES for c, _ in made)
    finally:
        launch._COUNTERS.remove(counts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_runner_counts_true_launches(replayed, case):
    """Through the stand-in graphs the runner gives the eager runner's
    trajectory and rebuilds bit for bit, in two calls on one loop (the
    second replaying every graph), and the launch counts equal the eager
    run's: chip_smoke.py's runner check passes on them and fails on the
    counts that a capture counted, or a replay left out, would give; the
    bench's far counter (its CUDA branch) reads the eager refreshes."""
    # with the kernels: on CPU tensors their wrappers run the plain sweeps
    _, tc = _pair(**dict(CASES[case], use_pallas=True))
    st = _tstate(disk_galaxy_jax(tc.n, seed=7, g=tc.g))
    counts, outs = {}, {}
    for graphed in (False, True):
        loops = {}
        launch.reset()
        with bench.far_counter(torch.device("cuda")) as far:
            outs[graphed] = [tsim._run_adaptive(loops, tc, st, 13, graphed)
                             for _ in range(2)]
            counts[graphed] = (dict(kern.LAUNCHES), far())
        (loop,) = loops.values()
        assert loop._rebuild_graph.captures == graphed
        assert (loop._rebuild_graph.graph is not None) == graphed
        assert graphed == any(g.graph is not None
                              for g in loop._steps.values())
    for (got, got_rb), (want, want_rb) in zip(outs[True], outs[False]):
        assert _same(got, want) and got_rb == want_rb
    assert _same(outs[True][0][0], outs[True][1][0])
    assert counts[True] == counts[False]
    launches, refreshes = counts[True]
    assert refreshes == launches["far_sweep"] >= 2
    per_call = {k: v // 2 for k, v in launches.items()}
    chip_smoke.check_runner_launches(per_call, 13)
    for off in (1, -1):
        with pytest.raises(RuntimeError, match="near launches"):
            chip_smoke.check_runner_launches(
                dict(per_call, near_span=per_call["near_span"] + off), 13)


def test_replayed_step_counts_one_launch_each(replayed):
    """Simulation.step through its stand-in graph: the eager step's state
    bit for bit, copies the next replay does not overwrite, and one
    launch of each kernel a step."""
    _, tc = _pair(**dict(BASE, n=1000, use_pallas=True))
    st = _tstate(disk_galaxy_jax(tc.n, seed=3, g=tc.g))
    sim = tsim.Simulation(tc, device="cpu")
    launch.reset()
    s1 = sim.step(st)
    s1_copy = tuple(x.clone() for x in s1)
    s2 = sim.step(s1)
    assert kern.LAUNCHES == {"far_sweep": 2, "table_sweep": 2,
                             "near_span": 2}
    assert _same(s1, s1_copy) and s1.mass is st.mass
    assert _same(s2, tsim.step_barnes_hut(tsim.step_barnes_hut(st, tc), tc))


def test_dropped_owners_free_their_graphs_without_a_cycle_collection(
        replayed):
    """A Simulation's loop and step, with their captured graphs (and so
    their memory pools), go with its last reference: a graph holds its
    owner's method weakly, so no reference cycle waits for the
    collector."""
    _, tc = _pair(**dict(CASES["hold4"], n=1000, use_pallas=True))
    st = _tstate(disk_galaxy_jax(tc.n, seed=5, g=tc.g))
    sim = tsim.Simulation(tc, device="cpu")
    sim.run_scan(st, 3)
    sim.step(st)
    (loop,), (step,) = sim._loops.values(), sim._steps.values()
    assert loop._rebuild_graph.graph is not None
    refs = [weakref.ref(x) for x in (sim, loop, loop._rebuild_graph,
                                     step, step._graph)]
    del sim, loop, step
    gc.disable()
    try:
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


# --- no capture on the CPU or in the sharded loop --------------------------


def test_cpu_runs_never_capture(monkeypatch):
    """run_scan (adaptive, per step, direct and fixed-K cycles with a
    remainder), step, the stepper, the drift protocol and the ensemble
    step run on the CPU without entering a capture, with the plain
    sweeps and with the hand kernels' wrappers (plain on CPU tensors)."""
    monkeypatch.setattr(graphs.Graphed, "_warm_up", _never)
    monkeypatch.setattr(graphs.Graphed, "_record", _never)
    _, tc = _pair(**CASES["span_age1_no_ss"])
    st = _tstate(disk_galaxy_jax(1000, seed=2, g=tc.g))
    sim = tsim.Simulation(tc, device="cpu")
    sim.run(sim.run_scan(st, 3), 4, callback=lambda k, s: None,
            callback_every=2)
    sim.make_stepper(st).advance(3)
    metrics.drift_protocol(sim, st, n_steps=3, chunk=2)
    k1 = tsim.Simulation(tc.replace(rebuild_every=1), device="cpu")
    k1.run_scan(k1.step(st), 2)
    for c in (tc, tc.replace(use_pallas=True)):
        direct = tsim.Simulation(c, method="direct", device="cpu")
        direct.run_scan(direct.step(st), 2)
        tsim.Simulation(c.replace(adaptive_rebuild=False, hold_farmid=4),
                        device="cpu").run_scan(st, 10)
        for method in ("barnes_hut", "direct"):
            tens.make_ensemble_step(c, method)(tens.stack_states([st, st]))


def test_sharded_loop_and_plain_sweeps_never_capture(monkeypatch, tmp_path):
    """Where every device captured, the single-process loop, the step,
    the direct step, the fixed-K cycles and the ensemble step would enter
    a capture with the hand kernels (their wrappers run the plain sweeps
    on CPU tensors), but not with the plain sweeps, which read back
    (use_pallas=False, the command line's --no-pallas); the rope-walk
    oracle, which reads back by design, never does; the sharded loop (on
    a 1-rank gloo mesh here) stays eager and runs the single process's
    schedule."""
    _, tc = _pair(**dict(CASES["hold4"], n=1024, use_pallas=True))
    st = _tstate(disk_galaxy_jax(tc.n, seed=4, g=tc.g))
    want, want_rb = tsim.make_adaptive_runner(tc, 5, return_stats=True)(st)
    monkeypatch.setattr(graphs, "capturable", lambda device: True)
    monkeypatch.setattr(graphs.Graphed, "_warm_up", _never)
    monkeypatch.setattr(graphs.Graphed, "_record", _never)
    pair = tens.stack_states([st, st])
    for fn in (lambda c: tsim.make_adaptive_runner(c, 5)(st),
               lambda c: tsim.Simulation(c, device="cpu").step(st),
               lambda c: tsim.Simulation(c, method="direct",
                                         device="cpu").step(st),
               lambda c: tsim.make_cycle_runner(c, 1, 4)(st),
               lambda c: tsim.Simulation(c.replace(adaptive_rebuild=False),
                                         device="cpu").run_scan(st, 6),
               lambda c: tens.make_ensemble_step(c)(pair),
               lambda c: tens.make_ensemble_step(c, "direct")(pair)):
        with pytest.raises(AssertionError, match="entered a capture"):
            fn(tc)
        fn(tc.replace(use_pallas=False))
    oracle = tsim.Simulation(tc, method="barnes_hut_reference", device="cpu")
    oracle.run_scan(oracle.step(st), 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = comm.make_mesh(1, "gloo", "cpu")
        got, got_rb = shard.make_sharded_adaptive_runner(
            tc, mesh, 5, return_stats=True)(shard.shard_state(st, mesh))
    finally:
        dist.destroy_process_group()
    assert got_rb == want_rb >= 1
    np.testing.assert_allclose(got.pos.numpy(), want.pos.numpy(), rtol=1e-5,
                               atol=1e-4)
