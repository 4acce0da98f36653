"""The port's last three compiled paths as captured graphs on the CPU,
through the stand-in for a CUDA graph (torch_graph_standin.py: a replay
runs the function again): the direct step (Simulation.step and
run_scan), the fixed-K cycles (run_scan with adaptive_rebuild=False and
make_cycle_runner, a remainder cycle included) and the ensemble step
(make_ensemble_step).  For each: two calls on one cached owner, the
second replaying, equal the eager run bit for bit; the launch counts
under replay equal eager's; the path agrees with nbody_tpu on the same
numpy inputs; and a dropped owner frees its graphs without a cycle
collection."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_jax, uniform_cube
from nbody_tpu.models import ensemble as jens
from nbody_tpu.models import simulation as jsim

from nbody_tpu_torch.convert import config_from_dict, state_from_numpy
from nbody_tpu_torch.models import ensemble as tens
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops.cuda import forces as kern
from nbody_tpu_torch.ops.cuda import launch

from torch_graph_standin import replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# tests/test_torch_runner.py's cycle-runner caps; the port runs its hand
# kernels' wrappers (plain on CPU tensors), nbody_tpu its jnp sweeps
CAPS = dict(force_tile=256, sup_cap=32, mid_cap=128, cmid_cap=256,
            near_cap=256, check_overflow=False)
# tests/test_torch_runner.py's trajectory tolerance against nbody_tpu (the
# port sums each sweep's float32 terms in float64, the JAX package in
# float32)
TRAJ = dict(rtol=1e-5, atol=1e-3)
# tests/test_torch_ensemble.py's bound on one ensemble step against
# nbody_tpu's vmapped step
ENS = dict(rtol=1e-5, atol=1e-4)


def _pair(**kw):
    """(nbody_tpu's config with its jnp sweeps, the port's with its hand
    kernels)."""
    jc = JConfig(**dict(kw, use_pallas=False))
    return jc, config_from_dict(dataclasses.asdict(jc)).replace(
        use_pallas=True)


def _tstate(js):
    return state_from_numpy(*(np.asarray(x) for x in js))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _close(got, want, tol):
    for g, w in zip(got[:2], want[:2]):          # pos, vel
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _counted(fn):
    """(fn(), the launches it counted)."""
    launch.reset()
    out = fn()
    return out, dict(kern.LAUNCHES)


# --- the direct step ----------------------------------------------------------


def test_replayed_direct_step_matches_eager_and_jax(replayed):
    """Simulation.step and run_scan of the direct method through one
    cached step graph (n = 2500: three row blocks of 1024): eager's
    states bit for bit, copies the next replay does not overwrite, no
    force kernel launched either way, and nbody_tpu's step_direct within
    TRAJ over three steps."""
    jc, tc = _pair(n=2500, **CAPS)
    js = uniform_cube(jc.n, seed=5)
    st = _tstate(js)
    sim = tsim.Simulation(tc, method="direct", device="cpu")
    (s1, s3), counts = _counted(lambda: (sim.step(st), sim.run_scan(st, 3)))
    s1_copy = tuple(x.clone() for x in s1)
    (step,) = sim._steps.values()
    assert step._graph.graph is not None
    (w1, w3), want_counts = _counted(lambda: (
        tsim.step_direct(st, tc),
        tsim.step_direct(tsim.step_direct(tsim.step_direct(st, tc), tc),
                         tc)))
    assert _same(s1, w1) and _same(s3, w3) and _same(s1, s1_copy)
    assert s1.mass is st.mass
    assert counts == want_counts == dict.fromkeys(counts, 0)
    jw = js
    for _ in range(3):
        jw = jsim.step_direct(jw, jc)
    _close(s3, jw, TRAJ)


# --- the fixed-K cycles -------------------------------------------------------


def test_replayed_cycles_match_eager_and_jax(replayed):
    """run_scan with adaptive_rebuild=False at K = 4, R = 4, n = 1000 (not
    a tile multiple): 6 steps (a cycle and a 2-step remainder, whose hold
    falls back to 1), then 10 from the same state on the same loop (two
    replays of the 4-step graph and one of the 2-step one): eager's cycle
    runners bit for bit, eager's launches, one loop with a graph for each
    cycle length; the 6 steps against nbody_tpu's run_scan within TRAJ;
    make_cycle_runner keeps its own loop across calls."""
    jc, tc = _pair(n=1000, rebuild_every=4, hold_farmid=4,
                   adaptive_rebuild=False, **CAPS)
    js = disk_galaxy_jax(jc.n, seed=7, g=jc.g)
    st = _tstate(js)

    def eager(n_cycles, rem):
        s = tsim.make_cycle_runner(tc, n_cycles, 4, graphs=False)(st)
        return tsim.make_cycle_runner(tc, 1, rem, graphs=False)(s)

    sim = tsim.Simulation(tc, device="cpu")
    got, want = {}, {}
    for steps in (6, 10):
        got[steps] = _counted(lambda: sim.run_scan(st, steps))
        want[steps] = _counted(lambda: eager(steps // 4, steps % 4))
        assert _same(got[steps][0], want[steps][0])
        assert got[steps][1] == want[steps][1]
    # a 4-step cycle refreshes far+mid once, the remainder's R = 1 twice
    assert got[10][1] == {"far_sweep": 4, "table_sweep": 4, "near_span": 10}
    (loop,) = sim._cycles.values()
    assert sorted(loop._cycles) == [2, 4]
    assert all(g.graph is not None for g in loop._cycles.values())
    flags = loop.cycle(4)
    assert flags.shape == (len(tsim.BUILD_FLAGS),)
    assert flags.dtype == torch.bool
    assert got[6][0].mass is st.mass
    _close(got[6][0], jsim.Simulation(jc).run_scan(js, 6), TRAJ)

    run = tsim.make_cycle_runner(tc, 1, 4)
    first = run(st)
    assert _same(run(st), first)
    assert _same(first, tsim.make_cycle_runner(tc, 1, 4, graphs=False)(st))


# --- the ensemble step --------------------------------------------------------


@pytest.mark.parametrize("method", ["barnes_hut", "direct"])
def test_replayed_ensemble_matches_eager_and_jax(replayed, method):
    """Three members of n = 600 through one cached ensemble graph, two
    steps (the second replaying): the eager ensemble (graphs=False) and
    each member's lone step bit for bit, eager's launches (one of each
    kernel a member a step), and nbody_tpu's jit(vmap(step)) within
    tests/test_torch_ensemble.py's bound on the first step."""
    jc, tc = _pair(n=600, **CAPS)
    jstates = [disk_galaxy_jax(jc.n, seed=s, g=jc.g) for s in range(3)]
    members = [_tstate(s) for s in jstates]
    batched = tens.stack_states(members)
    step = tens.make_ensemble_step(tc, method)
    eager = tens.make_ensemble_step(tc, method, graphs=False)
    lone = tsim.step_direct if method == "direct" else tsim.step_barnes_hut
    (g1, g2), counts = _counted(lambda: (step(batched), step(step(batched))))
    (e1, e2), want_counts = _counted(lambda: (eager(batched),
                                              eager(eager(batched))))
    assert _same(g1, e1) and _same(g2, e2)
    assert g1.mass is batched.mass
    assert counts == want_counts
    if method == "barnes_hut":
        assert counts == dict.fromkeys(counts, 3 * 3)
    for e, member in enumerate(members):
        alone = lone(lone(member, tc), tc)
        assert all(torch.equal(x[e], y) for x, y in zip(g2[:2], alone[:2]))
    want = jens.make_ensemble_step(jc, method)(jens.stack_states(jstates))
    _close(g1, want, ENS)


# --- the caches ----------------------------------------------------------------


def test_caches_serve_two_shapes(replayed):
    """One Simulation's fixed-K cycles at n = 1000, 1800 and 1010 (1000's
    padded rows, its loop reloaded) and one ensemble step at 2 and 3
    members: every call equals a fresh owner's bit for bit, one cycle
    loop per padded row count, one ensemble graph per (E, n); a loop
    refuses a state of other rows."""
    _, tc = _pair(n=1000, rebuild_every=4, hold_farmid=2,
                  adaptive_rebuild=False, **CAPS)
    sim = tsim.Simulation(tc, device="cpu")
    states = {n: _tstate(disk_galaxy_jax(n, seed=n, g=tc.g))
              for n in (1000, 1800, 1010)}
    for n in (1000, 1800, 1010, 1000):
        fresh = tsim.Simulation(tc, device="cpu")
        assert _same(sim.run_scan(states[n], 6),
                     fresh.run_scan(states[n], 6))
    assert sorted(k[1] for k in sim._cycles) == [1024, 2048]
    with pytest.raises(ValueError, match="pad to"):
        sim._cycles[(tc, 1024, torch.device("cpu"))].load(states[1800])
    step = tens.make_ensemble_step(tc)
    a, b = states[1000], _tstate(disk_galaxy_jax(1000, seed=3, g=tc.g))
    for members in ([a, b], [a, b, a], [b, a]):
        batched = tens.stack_states(members)
        assert _same(step(batched), tens.make_ensemble_step(tc)(batched))
    owners = next(c.cell_contents for c in step.__closure__
                  if isinstance(c.cell_contents, dict))
    assert sorted(k[:2] for k in owners) == [(2, 1000), (3, 1000)]


# --- owners dropped ------------------------------------------------------------


def test_dropped_path_owners_free_their_graphs_without_a_cycle_collection(
        replayed):
    """A direct Simulation's step graph, a Simulation's cycle loop with its
    graphs and an ensemble step's graph go with their last reference: no
    reference cycle waits for the collector."""
    _, tc = _pair(n=600, rebuild_every=4, hold_farmid=2,
                  adaptive_rebuild=False, **CAPS)
    st = _tstate(disk_galaxy_jax(tc.n, seed=5, g=tc.g))
    direct = tsim.Simulation(tc, method="direct", device="cpu")
    direct.step(st)
    cycles = tsim.Simulation(tc, device="cpu")
    cycles.run_scan(st, 6)
    ensemble = tens.make_ensemble_step(tc)
    ensemble(tens.stack_states([st, st]))
    (dstep,), (loop,) = direct._steps.values(), cycles._cycles.values()
    (owner,) = next(c.cell_contents for c in ensemble.__closure__
                    if isinstance(c.cell_contents, dict)).values()
    assert dstep._graph.graph is not None and owner._graph.graph is not None
    refs = [weakref.ref(x) for x in (direct, dstep, dstep._graph, cycles,
                                     loop, *loop._cycles.values(), ensemble,
                                     owner, owner._graph)]
    assert len(refs) == 10
    del direct, dstep, cycles, loop, ensemble, owner
    gc.disable()
    try:
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
