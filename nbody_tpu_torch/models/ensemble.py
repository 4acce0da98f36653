"""Ensemble (data-parallel) runs: E independent simulations of one
config (port of nbody_tpu/models/ensemble.py).

* `make_ensemble_step` advances a batched state ([E, N, 3] / [E, N])
  one step on one device.  The JAX package runs jit(vmap(step)); a hand
  kernel does not vmap, so each member runs its own launches of
  `step_barnes_hut` (or `step_direct`), the function the JAX ensemble
  maps, on its views of [E, ...] buffers.  On CUDA those launches are
  one captured CUDA graph (models/simulation._GraphedStep), and one
  replay advances the whole ensemble: the counterpart of jit(vmap).
* `shard_ensemble` / `make_sharded_ensemble_step` spread the members
  over the ranks of a mesh (parallel/comm.py): classic data
  parallelism, no collectives; each rank replays its own members'
  graph on its device.  The port's mesh is 1-D, so JAX's mesh axis
  name has no counterpart.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.models.simulation import (_GraphedStep,
                                               step_barnes_hut, step_direct)
from nbody_tpu_torch.parallel.comm import Mesh


def stack_states(states) -> ParticleState:
    """[E] list of ParticleState(n) -> ParticleState with [E, ...] fields."""
    return ParticleState(*(torch.stack(xs) for xs in zip(*states)))


def _members_step(step_fn):
    """`step_fn(state, cfg)` over every member of a batched state, each
    on its views of the [E, ...] fields; the results stacked."""
    def step(batched: ParticleState, cfg: SimConfig) -> ParticleState:
        return stack_states([
            step_fn(ParticleState(pos=p, vel=v, mass=m, acc=None), cfg)
            for p, v, m in zip(batched.pos, batched.vel, batched.mass)])

    return step


def make_ensemble_step(cfg: SimConfig, method: str = "barnes_hut",
                       graphs: bool = True):
    """A step over a batched ParticleState ([E, N, 3] / [E, N]): every
    member advanced by one step of `method` ("barnes_hut", the tiled
    production step, or "direct").  On CUDA, with the hand kernels, all
    members' steps are one captured graph (unless `graphs` is False),
    which the function keeps for each (E, N, device) it meets and
    replays in its later calls."""
    if method == "direct":
        members = _members_step(step_direct)
    elif method == "barnes_hut":
        members = _members_step(step_barnes_hut)      # force_fn "tiled"
    else:
        raise ValueError(method)
    owners: dict = {}       # (E, N, device) -> _GraphedStep

    def step(batched: ParticleState) -> ParticleState:
        key = (*batched.pos.shape[:2], batched.pos.device)
        owner = owners.get(key)
        if owner is None:
            owner = owners[key] = _GraphedStep(cfg, batched, members,
                                                 "ensemble", graphs)
        return owner(batched)

    return step


def shard_ensemble(batched: ParticleState, mesh: Mesh) -> ParticleState:
    """This rank's members of a batched state (E split evenly over the
    ranks, in rank order) on the mesh device."""
    e, d = batched.pos.shape[0], mesh.size
    if e % d:
        raise ValueError(f"{e} members do not split over {d} ranks")
    k = e // d
    return ParticleState(*(x[mesh.rank * k:(mesh.rank + 1) * k].to(
        mesh.device) for x in batched))


def make_sharded_ensemble_step(cfg: SimConfig, mesh: Mesh,
                               method: str = "barnes_hut"):
    """Data-parallel ensemble: each rank steps its own members
    (shard_ensemble), on CUDA through its own graph; zero
    collectives."""
    del mesh     # the members are already this rank's
    return make_ensemble_step(cfg, method)
