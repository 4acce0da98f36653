"""Physics metrics: kinetic and potential energy, momentum, bounding box,
the relative energy drift (the BASELINE.json physics criterion), the
kilostep drift protocol that measures it, the structure telemetry of the
Barnes-Hut build (cell count, band statistics, overflow flags) and the
run summary."""

from __future__ import annotations

import time
from typing import Dict

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops.forces import soft_term
from nbody_tpu_torch.state import ParticleState


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    """KE = 1/2 sum m |v|^2."""
    return 0.5 * (state.mass * (state.vel**2).sum(dim=1)).sum()


def potential_energy(state: ParticleState, cfg: SimConfig,
                     block: int = 256) -> torch.Tensor:
    """PE = -G sum_{i<j} m_i m_j / sqrt(|r_ij|^2 + soft), blocked O(N^2)
    on planar coordinates (the self pairs, 1/sqrt(soft) each, are
    subtracted afterwards).  Each [block, N] float32 temporary is 1 GB at
    N = 1M and the default block."""
    mass = state.mass
    g, soft = cfg.g, soft_term(cfg)
    px, py, pz = state.pos.t().contiguous()
    total = mass.new_zeros(())
    for i in range(0, mass.shape[0], block):
        j = slice(i, i + block)
        d = px[None, :] - px[j, None]
        d2 = d * d
        for q in (py, pz):
            torch.sub(q[None, :], q[j, None], out=d)
            d2.addcmul_(d, d)
        inv = d2.add_(soft).rsqrt_()
        total = total + ((inv * mass[None, :]).sum(dim=1) * mass[j]).sum()
    self_term = (mass * mass).sum() * soft ** -0.5
    return -0.5 * g * (total - self_term)


def momentum(state: ParticleState) -> torch.Tensor:
    return (state.mass[:, None] * state.vel).sum(dim=0)


def bounding_box(state: ParticleState):
    return state.pos.amin(dim=0), state.pos.amax(dim=0)


def total_energy(state: ParticleState, cfg: SimConfig) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state, cfg)


def energy_drift(e0: float, e1: float) -> float:
    """Relative drift |E1 - E0| / |E0|."""
    return abs(e1 - e0) / max(abs(e0), 1e-30)


def _sync(state: ParticleState) -> None:
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)


def drift_protocol(sim, state: ParticleState, n_steps: int = 1024,
                   chunk: int = 32, log=None) -> Dict:
    """The kilostep physics measurement: E0 = KE + softened PE of the
    state as given, then exactly ceil(n_steps/chunk)*chunk steps in
    `chunk`-sized ``sim.run_scan`` calls, then E1.  Times the whole
    evolution and its final chunk (host clock around synchronized work).

    `log(steps_done, seconds, state)` runs after each chunk when given;
    its time is excluded from the rates.

    Returns {drift, drift_steps, e0, e1, avg_steps_per_sec,
    hot_steps_per_sec, seconds, state}."""
    reps = -(-n_steps // chunk)
    total = reps * chunk
    e0 = float(total_energy(state, sim.cfg))
    _sync(state)
    t_log = 0.0
    t_all0 = time.perf_counter()
    t_hot0 = t_all0
    t_log_at_hot = 0.0
    for i in range(reps):
        if i == reps - 1:
            _sync(state)
            t_hot0 = time.perf_counter()
            t_log_at_hot = t_log
        state = sim.run_scan(state, chunk)
        if log is not None:
            _sync(state)
            tl0 = time.perf_counter()
            log(chunk * (i + 1), tl0 - t_all0 - t_log, state)
            t_log += time.perf_counter() - tl0
    _sync(state)
    t_end = time.perf_counter()
    e1 = float(total_energy(state, sim.cfg))
    return {
        "drift": energy_drift(e0, e1),
        "drift_steps": total,
        "e0": e0,
        "e1": e1,
        "avg_steps_per_sec": total / (t_end - t_all0 - t_log),
        "hot_steps_per_sec": chunk / (t_end - t_hot0 - (t_log - t_log_at_hot)),
        "seconds": t_end - t_all0 - t_log,
        "state": state,
    }


def _sorted_padded(state: ParticleState, cfg: SimConfig):
    """(codes, pos, mass, box_lo, box_size): Morton-sorted, tile-padded
    inputs of the production build."""
    from nbody_tpu_torch.models.simulation import sort_by_morton
    from nbody_tpu_torch.ops.forces import pad_sorted

    cs, perm, lo, size = sort_by_morton(state.pos, cfg)
    ps, ms, csp = pad_sorted(state.pos[perm], state.mass[perm], cs,
                             cfg.force_tile)
    return csp, ps, ms, lo, size


def cell_count(state: ParticleState, cfg: SimConfig) -> torch.Tensor:
    """Adaptive source-cell count (a device scalar): the analog of the
    legacy binaries' per-step "Nodes: %d" telemetry."""
    from nbody_tpu_torch.ops.cells import build_source_cells

    csp, ps, ms, lo, size = _sorted_padded(state, cfg)
    return build_source_cells(csp, ps, ms, cfg.force_tile, cfg.g,
                              cfg.cell_capacity, lo, size,
                              bits=cfg.morton_bits).n_cells


def bh_diagnostics(state: ParticleState, cfg: SimConfig) -> Dict:
    """Structure telemetry of one production build: the adaptive cell
    count, the band lists' mean live lengths per tile and the overflow
    flags."""
    from nbody_tpu_torch.ops.forces import build_bands

    csp, ps, ms, _, _ = _sorted_padded(state, cfg)
    cells, far, bands, _ = build_bands(ps, ms, csp, cfg)

    def mean(x):
        return float(x.to(torch.float32).mean())

    return {
        "n_cells": int(cells.n_cells),
        "n_supersupers": int(far.n_supers),
        "cell_capacity": int(cfg.cell_capacity),
        "cell_overflow": bool(cells.overflow),
        "g2_overflow": bool(cells.overflow_g2),
        "ss_mean": mean(bands.ss_cnt),
        "sup_mean": mean(bands.sup_cnt),
        "mid_mean": mean(bands.mid_cnt),
        "cmid_mean": mean(bands.cmid_cnt),
        "near_mean": mean(bands.near_cnt),
        "win_mean": mean(bands.win_cnt),
        "ss_overflow": bool(bands.ss_overflow),
        "sup_overflow": bool(bands.sup_overflow),
        "mid_overflow": bool(bands.mid_overflow),
        "cmid_overflow": bool(bands.cmid_overflow),
        "near_overflow": bool(bands.near_overflow),
    }


def summary(state: ParticleState, cfg: SimConfig,
            with_pe: bool = True) -> Dict:
    """Kinetic energy, momentum and bounding box (and, with_pe, the
    potential and total energy) as Python numbers."""
    lo, hi = bounding_box(state)
    p = momentum(state)
    out = {
        "ke": float(kinetic_energy(state)),
        "px": float(p[0]),
        "py": float(p[1]),
        "pz": float(p[2]),
        "bbox_min": [float(x) for x in lo],
        "bbox_max": [float(x) for x in hi],
    }
    if with_pe:
        out["pe"] = float(potential_energy(state, cfg))
        out["e_total"] = out["ke"] + out["pe"]
    return out
