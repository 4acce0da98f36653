"""nbody_tpu_torch's ensemble runs against the port's single-member step
and nbody_tpu's vmapped ensemble step (mirrors tests/test_ensemble.py's
two ensemble cases); the sharded ensemble on 8 gloo ranks."""

import dataclasses

import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_jax, uniform_cube
from nbody_tpu.models import ensemble as jens

from nbody_tpu_torch.convert import config_from_dict, state_from_numpy
from nbody_tpu_torch.models import ensemble as tens
from nbody_tpu_torch.models.simulation import Simulation, step_barnes_hut
from nbody_tpu_torch.parallel import jobs, launch

torch.set_num_threads(2)


def _cfgs(**kw):
    jc = JConfig(**kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _np_state(st):
    return tuple(np.asarray(x) for x in st)


def test_looped_ensemble_matches_individual_and_jax():
    """The looped ensemble step: each member bit-equal to the port's
    step_barnes_hut on that member alone and to Simulation.step, and
    within tests/test_ensemble.py's bound of JAX's vmapped step."""
    jc, tc = _cfgs(n=256, force_tile=64, use_pallas=False, sup_cap=16,
                   mid_cap=64, near_cap=64, ic_rng="jax")
    jstates = [disk_galaxy_jax(jc.n, seed=s, g=jc.g) for s in range(3)]
    tstates = [state_from_numpy(*_np_state(s)) for s in jstates]
    batched = tens.stack_states(tstates)
    assert batched.pos.shape == (3, jc.n, 3)
    out = tens.make_ensemble_step(tc)(batched)
    want_j = jens.make_ensemble_step(jc)(jens.stack_states(jstates))
    sim = Simulation(tc, device="cpu")
    for e in range(3):
        alone = step_barnes_hut(tstates[e], tc)
        for got, want in zip(out, alone):
            torch.testing.assert_close(got[e], want, rtol=0, atol=0)
        torch.testing.assert_close(out.pos[e], sim.step(tstates[e]).pos,
                                   rtol=0, atol=0)
        np.testing.assert_allclose(out.pos[e].numpy(),
                                   np.asarray(want_j.pos[e]), rtol=1e-5,
                                   atol=1e-4)


def test_ensemble_direct_method_and_bad_method():
    _, tc = _cfgs(n=128, force_tile=64, use_pallas=False, ic_rng="jax")
    states = [state_from_numpy(*_np_state(uniform_cube(tc.n, seed=s)))
              for s in range(2)]
    out = tens.make_ensemble_step(tc, method="direct")(
        tens.stack_states(states))
    from nbody_tpu_torch.models.simulation import step_direct
    for e in range(2):
        torch.testing.assert_close(out.pos[e], step_direct(states[e], tc).pos,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        tens.make_ensemble_step(tc, method="bogus")


def test_sharded_ensemble():
    """8 members over 8 gloo ranks, one member each and no collectives
    in the step: finite, the shape of the batch, and every member equal
    to the looped step on one device."""
    jc, tc = _cfgs(n=128, force_tile=64, use_pallas=False, sup_cap=16,
                   mid_cap=64, near_cap=32, ic_rng="jax")
    states = [state_from_numpy(*_np_state(uniform_cube(jc.n, seed=s)))
              for s in range(8)]
    batched = tens.stack_states(states)
    res = launch.spawn(jobs.run, 8, backend="gloo", device="cpu",
                       timeout=120, args=([("sharded_ensemble",
                                            dict(cfg=tc, batched=batched))],))
    out = res[0][0]
    assert out.pos.shape == (8, jc.n, 3)
    assert torch.isfinite(out.pos).all()
    want = tens.make_ensemble_step(tc)(batched)
    for got, w in zip(out, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        from nbody_tpu_torch.parallel.comm import Mesh
        tens.shard_ensemble(tens.stack_states(states[:3]),
                            Mesh(rank=0, size=2, device=torch.device("cpu"),
                                 backend="gloo"))
