"""Simulation configuration for the PyTorch/CUDA port.

A field-for-field copy of ``nbody_tpu.config.SimConfig`` and ``PRESETS``
(the port imports nothing of ``nbody_tpu``).  Field names, defaults, the
derived sizes and the ``__post_init__`` checks are the same, so a config
carries across with ``nbody_tpu_torch.convert.config_from_dict``.

``use_pallas`` keeps its name for that reason and means "hand kernels on":
the three force sweeps run as the CUDA kernels of ``ops/cuda/forces.py``
(``False`` asks for their plain PyTorch versions).  The band-reuse
runners read ``rebuild_every``, ``adaptive_rebuild``, ``hold_farmid`` and
the skin and hold knobs and the renderer its camera and frame size; the
fields of sharding are carried for parity and read by nothing in the
port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All knobs of the simulation (see nbody_tpu/config.py for the
    measurement history behind each default)."""

    # --- workload ---
    n: int = 500_000               # particle count
    # --- physics ---
    g: float = 0.5                 # G_CONST
    theta: float = 0.5             # Barnes-Hut opening angle
    dt: float = 0.02
    softening: float = 50.0        # added to the SQUARED distance (v5);
                                   # legacy_softening adds softening^2
    max_speed: float = 500.0       # MAX_SPEED clamp
    damping: float = 1.0           # defined but disabled in v5
    legacy_softening: bool = False
    clamp_speed: bool = True
    # --- tree / traversal ---
    morton_bits: int = 63          # 63 (21-level cells) or 30 (10 levels)
    force_tile: int = 256          # particles per target tile (B)
    ss_cap: int = 192              # max MAC-failing super-supers per tile
    sup_cap: int = 256             # max MAC-failing supers per tile
    mid_cap: int = 320             # max failing cells per tile
    cmid_cap: int = 512            # max failing children refined to
                                   # grandchild monopoles per tile
    near_cap: int = 1024           # max exact-P2P children per tile
    win_cap: int = 512             # max distinct near source windows
    cell_cap_factor: int = 5       # cell capacity = factor * n_groups + 64
    g2_cap_factor: int = 4         # grandchild capacity / child capacity
    no_ss: bool = False            # every super-super fails its MAC (far
                                   # field telescopes to super monopoles);
                                   # requires ss_cap >= n_ss
    use_pallas: bool = True        # hand kernels (CUDA) vs plain torch
    rebuild_every: int = 1
    skin_safety: float = 1.3
    adaptive_rebuild: bool = True
    skin_width_cap: float = 0.75
    skin_width_floor: float = 2.0**-10
    horizon_floor: int = 1
    hold_farmid: int = 1
    farmid_span_rebuilds: bool = False
    span_age_mult: int = 0
    hold_predict: int = 0
    refresh_moments: bool = False
    check_overflow: bool = True    # one-time probe on the first step
    # --- initial conditions ---
    seed: int = 42
    ic_kind: str = "disk_galaxy"   # "disk_galaxy" | "legacy_disk" |
                                   # "uniform_cube"
    ic_rng: str = "msvc_rand"      # "msvc_rand" (bit-exact C rand()) |
                                   # "jax" (the port's torch.Generator)
    # --- parallelism ---
    mesh_shape: Tuple[int, ...] = ()
    near_halo_div: int = 8
    near_fetch_cap: int = 512
    # --- render ---
    render_width: int = 1280
    render_height: int = 720
    cam_distance: float = 4000.0
    cam_rot_x: float = 30.0
    cam_rot_y: float = 45.0
    fov_deg: float = 45.0

    def __post_init__(self):
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.morton_bits not in (30, 63):
            raise ValueError("morton_bits must be 30 or 63")
        if self.softening <= 0:
            raise ValueError(
                "softening must be positive: the force law divides by "
                "sqrt(d^2 + softening) and self-interactions rely on it"
            )
        if self.force_tile % (8 * 8):
            raise ValueError("force_tile must be a multiple of 64 "
                             "(8 sub-blocks, 128-lane DMA alignment /2)")
        if self.use_pallas and self.force_tile % 128:
            raise ValueError("force_tile must be a multiple of 128 when "
                             "use_pallas=True")
        if self.force_tile > 1024:
            raise ValueError("force_tile must be <= 1024")
        if (
            not self.adaptive_rebuild
            and self.hold_farmid > 1
            and self.rebuild_every % self.hold_farmid
        ):
            raise ValueError(
                f"hold_farmid={self.hold_farmid} must divide "
                f"rebuild_every={self.rebuild_every} when "
                "adaptive_rebuild=False (the fixed-K cycle runner would "
                "otherwise silently disable the far+mid hold)"
            )

    @property
    def n_groups(self) -> int:
        """Target tiles after padding to a force_tile multiple."""
        return -(-self.n // self.force_tile)

    @property
    def win_pieces(self) -> int:
        """Aligned 128-wide windows one near-child run can touch: runs are
        bounded by force_tile, so ceil(force_tile/128) + 1."""
        return -(-self.force_tile // 128) + 1

    @property
    def win_cap_eff(self) -> int:
        """Per-tile window-slot cap, clamped to the structural maximum."""
        return min(self.win_cap, self.win_pieces * self.near_cap)

    @property
    def cell_capacity(self) -> int:
        """Static capacity for adaptive source cells (multiple of 64, so
        cells group into whole supers and super-supers)."""
        cap = self.cell_cap_factor * self.n_groups + 64
        return -(-cap // 64) * 64

    @property
    def table_bytes(self) -> int:
        """Device-memory footprint of ONE TableSet (4 fp32 planes of
        near_cap + 9*(ss+sup+mid+cmid) rows per tile)."""
        rows = self.near_cap + 9 * (
            self.ss_cap + self.sup_cap + self.mid_cap + self.cmid_cap
        )
        return 4 * 4 * self.n_groups * rows

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


PRESETS = {
    # direct all-pairs O(N^2), oracle size
    "simple": SimConfig(n=4096),
    # nbody_bh legacy golden-file workload
    "bh_legacy": SimConfig(
        n=10_000, theta=0.5, dt=0.03, morton_bits=63,
        legacy_softening=True, clamp_speed=False, ic_kind="legacy_disk",
    ),
    # nbody_v5 interactive
    "v5": SimConfig(n=500_000, rebuild_every=16, hold_farmid=8,
                    force_tile=512, farmid_span_rebuilds=True,
                    span_age_mult=1, no_ss=True),
    # nbody_v5_bench at N = 1M: the shipping configuration
    "v5_bench": SimConfig(n=1_000_000, rebuild_every=16, hold_farmid=8,
                          force_tile=512, farmid_span_rebuilds=True,
                          span_age_mult=1, no_ss=True),
    "bh_100k": SimConfig(n=100_000, rebuild_every=16, hold_farmid=8),
    "bh_4m": SimConfig(n=4_000_000, force_tile=512, rebuild_every=8,
                       hold_farmid=4, sup_cap=384, mid_cap=512,
                       cmid_cap=768, near_cap=1536, g2_cap_factor=6),
    "sharded_4m": SimConfig(n=4_000_000, mesh_shape=(8,), force_tile=512,
                            rebuild_every=8, hold_farmid=4, sup_cap=384,
                            mid_cap=512, cmid_cap=768, near_cap=1536,
                            g2_cap_factor=6),
}
