"""Per-step simulation pipelines and the user-facing `Simulation`.

`step_barnes_hut` rebuilds everything each step, as the reference's
simulationStep() does (nbody_v5.cu:298-325): bounding cube -> Morton
codes -> stable sort -> adaptive cells and band structures -> the three
force sweeps -> Euler-Cromer.  `step_direct` is the O(N^2) oracle.
Particles stay in their original order across steps; the Morton
permutation is internal to a step.
"""

from __future__ import annotations

import warnings

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.ops import bbox, morton, forces, integrate as integ
from nbody_tpu_torch.ops.cells import build_source_cells


def sort_by_morton(pos: torch.Tensor, cfg: SimConfig):
    """(codes_sorted int64 [N], perm, lo, size) at cfg.morton_bits."""
    lo, size = bbox.bounding_cube(pos)
    encode = morton.encode63 if cfg.morton_bits == 63 else morton.encode30
    codes_s, perm = morton.morton_sort(encode(pos, lo, size))
    return codes_s, perm, lo, size


def compute_bh_acc(pos: torch.Tensor, mass: torch.Tensor,
                   cfg: SimConfig) -> torch.Tensor:
    """Barnes-Hut accelerations in the particles' original order."""
    n = pos.shape[0]
    codes_s, perm, _, _ = sort_by_morton(pos, cfg)
    pos_p, mass_p, codes_p = forces.pad_sorted(pos[perm], mass[perm], codes_s,
                                               cfg.force_tile)
    acc_s = forces.bh_forces_grouped(pos_p, mass_p, codes_p, cfg)[:n]
    out = torch.empty_like(acc_s)
    out[perm] = acc_s                   # back to the original order
    return out


def step_barnes_hut(state: ParticleState, cfg: SimConfig) -> ParticleState:
    return integ.integrate(state, compute_bh_acc(state.pos, state.mass, cfg),
                           cfg)


def step_direct(state: ParticleState, cfg: SimConfig) -> ParticleState:
    return integ.integrate(state, forces.direct_forces(state.pos, state.mass,
                                                       cfg), cfg)


class Simulation:
    """Owns a config, a device and a step function.

    method: "barnes_hut" (per-step rebuild, hand kernels when
    cfg.use_pallas) or "direct" (O(N^2)).  `device` defaults to CUDA and
    raises when no GPU is present; pass device="cpu" to run the plain
    versions on the CPU."""

    def __init__(self, cfg: SimConfig, method: str = "barnes_hut",
                 device=None):
        if method not in ("barnes_hut", "direct"):
            raise ValueError(f"unknown method {method}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Simulation runs on CUDA by default and "
                                   "no CUDA device is present; pass "
                                   "device='cpu' to run on the CPU")
            device = "cuda"
        self.cfg = cfg
        self.method = method
        self.device = torch.device(device)
        self._overflow_checked = method != "barnes_hut" or not cfg.check_overflow

    def init_state(self) -> ParticleState:
        from nbody_tpu_torch.init import make_initial_state

        return make_initial_state(self.cfg, device=self.device)

    def step(self, state: ParticleState) -> ParticleState:
        if state.device.type != self.device.type:
            raise ValueError(f"state lies on {state.device}, the "
                             f"simulation on {self.device}")
        self._check_overflow(state)
        if self.method == "direct":
            return step_direct(state, self.cfg)
        return step_barnes_hut(state, self.cfg)

    def _check_overflow(self, state: ParticleState) -> None:
        """One-time guard on the first step: cell-capacity overflow drops
        whole cells (their mass is missing from every force), so warn
        loudly; grandchild-cap overflow is graceful and warned for
        tuning.  cfg.check_overflow=False skips it."""
        if self._overflow_checked:
            return
        self._overflow_checked = True
        cfg = self.cfg
        cs, perm, lo, size = sort_by_morton(state.pos, cfg)
        ps, ms, csp = forces.pad_sorted(state.pos[perm], state.mass[perm], cs,
                                        cfg.force_tile)
        cells = build_source_cells(csp, ps, ms, cfg.force_tile, cfg.g,
                                   cfg.cell_capacity, lo, size,
                                   g2_factor=cfg.g2_cap_factor,
                                   bits=cfg.morton_bits)
        if bool(cells.overflow):
            warnings.warn(
                f"adaptive-cell capacity overflow: n_cells="
                f"{int(cells.n_cells)} > cell_capacity={cfg.cell_capacity}; "
                "truncated cells' mass is MISSING from all forces — raise "
                f"cfg.cell_cap_factor (now {cfg.cell_cap_factor})",
                RuntimeWarning, stacklevel=3)
        elif bool(cells.overflow_g2):
            warnings.warn(
                "grandchild-segment cap overflow (graceful): some children "
                "take exact P2P instead of grandchild monopoles — raise "
                f"cfg.g2_cap_factor (now {cfg.g2_cap_factor})",
                RuntimeWarning, stacklevel=3)
