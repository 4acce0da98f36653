"""The upstream disk galaxy (nbody_v5.cu:395-414) from the MSVC ``rand()``
stream after ``srand(seed)``: a frozen copy of
``nbody_tpu_torch.init.disk_galaxy_msvc``, so that the benchmark makes its
own inputs.  Float32 NumPy on the host; the stream is drawn by jump-ahead
doubling, not one call at a time."""

from __future__ import annotations

import numpy as np

_MSVC_A = np.uint64(214013)
_MSVC_C = np.uint64(2531011)
_MASK32 = np.uint64(0xFFFFFFFF)


def msvc_rand_sequence(seed: int, count: int) -> np.ndarray:
    """First `count` outputs of MSVC rand() after srand(seed), as uint16.
    If S[k] is the LCG state after k+1 steps, S[k+L] = a_L S[k] + b_L
    (mod 2^32), where (a_L, b_L) compose by squaring."""
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
    return ((states[:count] >> np.uint64(16))
            & np.uint64(0x7FFF)).astype(np.uint16)


def make(n: int, seed: int, g: float, device=None):
    """(pos [n, 3], vel [n, 3], mass [n]) float32 NumPy arrays; per body
    five draws in statement order: radius, angle, z-offset, mass,
    z-velocity.  `device` is unused: the stream is drawn on the host."""
    f32 = np.float32
    u = (msvc_rand_sequence(seed, 5 * n).astype(np.float32)
         / f32(32767.0)).reshape(n, 5)
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
    return pos, vel, mass.astype(np.float32)
