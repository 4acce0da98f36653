"""Initial-condition generators.

`disk_galaxy_msvc` rebuilds the v5 host loop (nbody_v5.cu:395-414) from a
bit-exact MSVC ``rand()`` stream after ``srand(seed)``, in float32 numpy,
so the port starts from the same particle cloud as the reference binaries
and as ``nbody_tpu``.  The other generators draw from a seeded
``torch.Generator`` on the target device: same distributions as the JAX
package's ``jax.random`` versions, different numbers.  Every generator
builds its state on CUDA unless `device` names another device, and
raises when no CUDA device is present (``state.default_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState, default_device

_MSVC_A = np.uint64(214013)
_MSVC_C = np.uint64(2531011)
_MASK32 = np.uint64(0xFFFFFFFF)


def msvc_rand_sequence(seed: int, count: int) -> np.ndarray:
    """First `count` outputs of MSVC rand() after srand(seed), as uint16.

    Vectorized with jump-ahead doubling: if S[k] is the LCG state after
    k+1 steps, S[k+L] = a_L*S[k] + b_L (mod 2^32), where (a_L, b_L)
    compose by squaring.
    """
    if count == 0:
        return np.empty((0,), np.uint16)
    s0 = np.uint64(seed & 0xFFFFFFFF)
    states = np.array([(_MSVC_A * s0 + _MSVC_C) & _MASK32], dtype=np.uint64)
    a, b = _MSVC_A, _MSVC_C
    with np.errstate(over="ignore"):
        while states.shape[0] < count:
            ext = (a * states + b) & _MASK32
            states = np.concatenate([states, ext])
            a, b = (a * a) & _MASK32, (a * b + b) & _MASK32
    return ((states[:count] >> np.uint64(16)) & np.uint64(0x7FFF)).astype(np.uint16)


def msvc_rand_floats(seed: int, count: int) -> np.ndarray:
    """`(float)rand()/RAND_MAX` as float32 (RAND_MAX = 32767)."""
    return msvc_rand_sequence(seed, count).astype(np.float32) / np.float32(32767.0)


def disk_galaxy_msvc(n: int, seed: int = 42, g: float = 0.5,
                     device=None) -> ParticleState:
    """The v5 disk galaxy from the MSVC stream; per particle five draws
    in statement order: radius, angle, z-offset, mass, z-velocity."""
    f32 = np.float32
    u = msvc_rand_floats(seed, 5 * n).reshape(n, 5)
    r = f32(200.0) + u[:, 0] * f32(1500.0)
    a = u[:, 1] * (f32(2.0) * f32(np.pi))
    px = r * np.cos(a)
    py = r * np.sin(a)
    pz = (u[:, 2] - f32(0.5)) * (r * f32(0.05))
    mass = f32(2.0) + u[:, 3] * f32(5.0)
    # circular orbital speed from the approximate enclosed mass
    approx_mass_inside = f32(50000.0) + r * f32(100.0)
    v_mag = np.sqrt(f32(g) * approx_mass_inside / r)
    vx = -np.sin(a) * v_mag
    vy = np.cos(a) * v_mag
    vz = (u[:, 4] - f32(0.5)) * f32(2.0)
    pos = np.stack([px, py, pz], axis=1).astype(np.float32)
    vel = np.stack([vx, vy, vz], axis=1).astype(np.float32)
    return ParticleState.create(pos, vel, mass.astype(np.float32),
                                device=default_device(device))


def _uniform(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def disk_galaxy_torch(n: int, seed: int = 42, g: float = 0.5,
                      device=None) -> ParticleState:
    """The disk-galaxy distribution drawn on the device (counterpart of
    nbody_tpu's disk_galaxy_jax; not bit-identical to the MSVC stream)."""
    device = default_device(device)
    ku = _uniform((n, 5), seed, device)
    r = 200.0 + ku[:, 0] * 1500.0
    a = ku[:, 1] * (2.0 * np.pi)
    pos = torch.stack([r * torch.cos(a), r * torch.sin(a),
                       (ku[:, 2] - 0.5) * (r * 0.05)], dim=1)
    mass = 2.0 + ku[:, 3] * 5.0
    v_mag = torch.sqrt(g * (50000.0 + r * 100.0) / r)
    vel = torch.stack([-torch.sin(a) * v_mag, torch.cos(a) * v_mag,
                       (ku[:, 4] - 0.5) * 2.0], dim=1)
    return ParticleState.create(pos, vel, mass)


def legacy_disk(n: int, seed: int = 0, device=None) -> ParticleState:
    """Distributional rebuild of the nbody_bh IC: r = u*400 disk,
    solid-rotation velocity 0.01 * r_perp, no out-of-plane velocity."""
    device = default_device(device)
    ku = _uniform((n, 3), seed, device)
    a = ku[:, 0] * (2.0 * np.pi)
    r = ku[:, 1] * 400.0
    pos = torch.stack([r * torch.cos(a), r * torch.sin(a),
                       (ku[:, 2] - 0.5) * 100.0], dim=1)
    vel = torch.stack([-pos[:, 1] * 0.01, pos[:, 0] * 0.01,
                       torch.zeros_like(r)], dim=1)
    return ParticleState.create(pos, vel, torch.ones_like(r))


def uniform_cube(n: int, seed: int = 0, half: float = 1000.0,
                 device=None) -> ParticleState:
    """Uniform random cube at rest, masses uniform in [1, 5)."""
    device = default_device(device)
    ku = _uniform((n, 4), seed, device)
    pos = -half + ku[:, :3] * (2.0 * half)
    mass = 1.0 + ku[:, 3] * 4.0
    return ParticleState.create(pos, torch.zeros_like(pos), mass)


def make_initial_state(cfg: SimConfig, device=None) -> ParticleState:
    """Dispatch on cfg.ic_kind / cfg.ic_rng ("jax" selects the device
    generator, the port's counterpart of the jax.random stream)."""
    if cfg.ic_kind == "disk_galaxy":
        if cfg.ic_rng == "msvc_rand":
            return disk_galaxy_msvc(cfg.n, cfg.seed, cfg.g, device=device)
        return disk_galaxy_torch(cfg.n, cfg.seed, cfg.g, device=device)
    if cfg.ic_kind == "legacy_disk":
        return legacy_disk(cfg.n, cfg.seed, device=device)
    if cfg.ic_kind == "uniform_cube":
        return uniform_cube(cfg.n, cfg.seed, device=device)
    raise ValueError(f"unknown ic_kind: {cfg.ic_kind}")
