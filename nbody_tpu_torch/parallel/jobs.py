"""Rank functions for parallel/launch.spawn.

A rank of a spawned mesh starts from a fresh interpreter and unpickles
the function it runs by module and name, so the functions live here, in
a module that imports neither JAX nor the JAX package.  `run` is the
one to spawn: it runs a list of jobs, named functions of this module, on
the rank's mesh in order, and returns their results (moved to the CPU
by launch.spawn):

    results = launch.spawn(jobs.run, 8, backend="gloo", device="cpu",
                           timeout=120, args=([
                               ("sharded_adaptive", dict(cfg=cfg,
                                    state=state, n_steps=10)),
                           ],))

Inputs are full arrays (the state, windows, permutations) as CPU
tensors or numpy arrays; each job moves them to the mesh device and
takes its rank's rows.  Most results are replicated (the runners
return the full state on every rank); `pieces` returns this rank's own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.models import ensemble
from nbody_tpu_torch.models.simulation import sort_by_morton
from nbody_tpu_torch.parallel import comm, shard
from nbody_tpu_torch.parallel.comm import Mesh


def _on(x: Any, device: torch.device) -> Any:
    """x with every array (tensor or numpy) moved to `device`, through
    tuples, lists, dicts and NamedTuples."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    return x


def _state(state) -> ParticleState:
    return state if isinstance(state, ParticleState) else ParticleState(*state)


def sharded_step(mesh: Mesh, cfg: SimConfig, state, n_steps: int
                 ) -> ParticleState:
    """n_steps of make_sharded_step; the full state."""
    step = shard.make_sharded_step(cfg, mesh)
    st = shard.shard_state(_state(state), mesh)
    for _ in range(n_steps):
        st = step(st)
    return ParticleState(*(comm.all_gather(x, mesh) for x in st))


def sharded_cycles(mesh: Mesh, cfg: SimConfig, state, n_cycles: int,
                   k: int) -> ParticleState:
    """make_sharded_runner(n_cycles, k); the full state."""
    run = shard.make_sharded_runner(cfg, mesh, n_cycles, k)
    return run(shard.shard_state(_state(state), mesh))


def sharded_adaptive(mesh: Mesh, cfg: SimConfig, state, n_steps: int
                     ) -> Tuple[ParticleState, int]:
    """make_sharded_adaptive_runner(n_steps, return_stats=True): (the
    full state, the rebuild count)."""
    run = shard.make_sharded_adaptive_runner(cfg, mesh, n_steps,
                                             return_stats=True)
    return run(shard.shard_state(_state(state), mesh))


def _fetch_ok(n_far: torch.Tensor, cfg: SimConfig, mesh: Mesh) -> bool:
    """The window fetch plan holds on every rank (the rebuild's test of
    each rank's _near_fetch_plan count)."""
    over = (n_far > cfg.near_fetch_cap).to(torch.int64).reshape(1)
    return bool(comm.psum(over, mesh)[0] == 0)


def _sorted_slab(cfg: SimConfig, state, mesh: Mesh):
    """The global sorted, tile-padded arrays of `state` and this rank's
    classification of them."""
    st = _state(state)
    codes_s, perm, _, _ = sort_by_morton(st.pos, cfg)
    ps, ms, cs = forces.pad_sorted(st.pos[perm], st.mass[perm], codes_s,
                                   cfg.force_tile)
    _, _, bands, _, my_pos = shard._classify_slab(ps, ms, cs, cfg, mesh)
    return ps, ms, bands, my_pos


def near_paths(mesh: Mesh, cfg: SimConfig, state) -> Dict[str, Any]:
    """On `state`'s rebuild: whether the halo alone reaches every near
    window, whether the window fetch plan holds, and MY slab's near band
    on the halo + fetch path and on the all_gather path."""
    ps, ms, bands, my_pos = _sorted_slab(cfg, state, mesh)
    m = my_pos.shape[0]
    h = shard._near_halo_rows(m, cfg)
    halo_ok = shard._near_reach_ok(bands, m, h, mesh)
    n_far, starts_srv, wf_remap = shard._near_fetch_plan(bands, m, h, cfg,
                                                         mesh)
    fetch_ok = _fetch_ok(n_far, cfg, mesh)
    start = mesh.rank * m
    my_mass = ms[start:start + m]
    reqs_g = comm.all_gather(starts_srv, mesh).reshape(mesh.size, -1)
    p_src = torch.cat([shard._halo_ext(my_pos, h, mesh),
                       shard._fetch_windows(my_pos, reqs_g, m, mesh)])
    m_src = torch.cat([shard._halo_ext(my_mass, h, mesh),
                       shard._fetch_windows(my_mass, reqs_g, m, mesh)])
    a_fast = forces.apply_near(my_pos, p_src, m_src,
                               bands._replace(win_first=wf_remap), cfg)
    a_slow = forces.apply_near(my_pos, ps, ms, bands, cfg)
    return {"halo_ok": bool(halo_ok), "fetch_ok": fetch_ok,
            "a_fast": a_fast, "a_slow": a_slow}


def near_halo_windows(mesh: Mesh, cfg: SimConfig, pos, mass, win_first,
                      win_mask, h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MY slab's near band over given per-tile windows (every tile of
    the full arrays; rank d takes its slab's tiles), from the halo with
    the windows rebased and from the all_gather: (fast, slow)."""
    d, me = mesh.size, mesh.rank
    m = pos.shape[0] // d
    t = win_first.shape[0] // d
    pos_l, mass_l = pos[me * m:(me + 1) * m], mass[me * m:(me + 1) * m]
    wf = win_first[me * t:(me + 1) * t]
    wm = win_mask[me * t:(me + 1) * t]
    wc = torch.full((t,), wf.shape[1], dtype=wf.dtype, device=wf.device)
    rebased = torch.clamp(wf - (me * m - h), min=0)
    a_fast = forces.near_correction_torch(
        pos_l, shard._halo_ext(pos_l, h, mesh),
        shard._halo_ext(mass_l, h, mesh), rebased, wm, wc, cfg)
    a_slow = forces.near_correction_torch(
        pos_l, comm.all_gather(pos_l, mesh), comm.all_gather(mass_l, mesh),
        wf, wm, wc, cfg)
    return a_fast, a_slow


def reslab(mesh: Mesh, x, perm, h: int) -> Tuple[torch.Tensor, bool]:
    """_reslab of the full array `x` (rank d holds slab d) by the global
    permutation `perm`: (the re-slabbed full array, any_out)."""
    m = x.shape[0] // mesh.size
    plan = shard._reslab_plan(perm, m, h, mesh)
    any_out = bool(comm.psum(plan.n_out.reshape(1), mesh)[0] > 0)
    (out,) = shard._reslab((x[mesh.rank * m:(mesh.rank + 1) * m],), plan,
                           any_out, h, mesh)
    return comm.all_gather(out, mesh), any_out


def pieces(mesh: Mesh, cfg: SimConfig, per_rank: Sequence[Dict[str, Any]]
           ) -> Dict[str, Any]:
    """The near-exchange pieces on this rank's inputs (per_rank[rank]:
    `bands`, the slab rows `x` and `mass`, `m`, `h`) and the
    owner-computes cells of global sorted arrays (`codes`, `pos_s`,
    `mass_s`, `drift`, box `lo` and `size`): reach_ok, fetch_ok,
    starts_srv, wf_remap, the halo and fetched rows, and the stitched
    global SourceCells."""
    inp = per_rank[mesh.rank]
    bands, x, m, h = inp["bands"], inp["x"], inp["m"], inp["h"]
    n_far, starts_srv, wf_remap = shard._near_fetch_plan(bands, m, h, cfg,
                                                         mesh)
    reqs_g = comm.all_gather(starts_srv, mesh).reshape(mesh.size, -1)
    cells, codes_own = shard._cells_sharded(
        inp["codes"], inp["pos_s"], inp["mass_s"], cfg, inp["lo"],
        inp["size"], mesh, drift=inp["drift"])
    return {
        "reach_ok": bool(shard._near_reach_ok(bands, m, h, mesh)),
        "fetch_ok": _fetch_ok(n_far, cfg, mesh),
        "starts_srv": starts_srv, "wf_remap": wf_remap,
        "halo": shard._halo_ext(x, h, mesh),
        "halo_mass": shard._halo_ext(inp["mass"], h, mesh),
        "fetched": shard._fetch_windows(x, reqs_g, m, mesh),
        "cells": cells, "codes_own": codes_own,
    }


def sharded_ensemble(mesh: Mesh, cfg: SimConfig, batched) -> ParticleState:
    """One make_sharded_ensemble_step over this rank's members of the
    batched state; every member, gathered in order."""
    mine = ensemble.shard_ensemble(_state(batched), mesh)
    out = ensemble.make_sharded_ensemble_step(cfg, mesh)(mine)
    return ParticleState(*(comm.all_gather(x, mesh) for x in out))


JOBS = {f.__name__: f for f in (sharded_step, sharded_cycles,
                                sharded_adaptive, near_paths,
                                near_halo_windows, reslab, pieces,
                                sharded_ensemble)}


def run(mesh: Mesh, jobs: List[Tuple[str, Dict[str, Any]]]) -> List[Any]:
    """Each (name, kwargs) job of `jobs` in order on this rank, its
    array inputs moved to the mesh device; their results."""
    return [JOBS[name](mesh, **_on(kw, mesh.device)) for name, kw in jobs]
