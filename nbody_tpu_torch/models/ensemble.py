"""Ensemble (data-parallel) runs: E independent simulations of one
config (port of nbody_tpu/models/ensemble.py).

* `make_ensemble_step` advances a batched state ([E, N, 3] / [E, N])
  one step on one device.  The JAX package vmaps the step; a hand
  kernel does not vmap, so this loops over the members, each through
  `step_barnes_hut` (or `step_direct`), the function the JAX ensemble
  maps.
* `shard_ensemble` / `make_sharded_ensemble_step` spread the members
  over the ranks of a mesh (parallel/comm.py): classic data
  parallelism, no collectives.  The port's mesh is 1-D, so JAX's mesh
  axis name has no counterpart.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.models.simulation import step_barnes_hut, step_direct
from nbody_tpu_torch.parallel.comm import Mesh


def stack_states(states) -> ParticleState:
    """[E] list of ParticleState(n) -> ParticleState with [E, ...] fields."""
    return ParticleState(*(torch.stack(xs) for xs in zip(*states)))


def make_ensemble_step(cfg: SimConfig, method: str = "barnes_hut"):
    """A step over a batched ParticleState ([E, N, 3] / [E, N]): every
    member advanced by one step of `method` ("barnes_hut", the tiled
    production step, or "direct")."""
    if method == "direct":
        def fn(st):
            return step_direct(st, cfg)
    elif method == "barnes_hut":
        def fn(st):
            return step_barnes_hut(st, cfg, force_fn="tiled")
    else:
        raise ValueError(method)

    def step(batched: ParticleState) -> ParticleState:
        return stack_states([fn(ParticleState(*(x[e] for x in batched)))
                             for e in range(batched.pos.shape[0])])

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
    (shard_ensemble); zero collectives."""
    del mesh     # the members are already this rank's
    return make_ensemble_step(cfg, method)
