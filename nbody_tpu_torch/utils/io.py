"""State dumps, dump parsing, and checkpoint/restore.

The dump format is the legacy result files' (output_bh.txt:1-4): a
4-line '#' header, then one `x y z vx vy vz` row per body at %.6f.  The
native C++ writer (nbody_tpu_torch/native) formats it when it builds;
otherwise numpy.savetxt writes the same bytes, with a warning that says
why the native writer is missing.

Checkpoints are npz files with the JAX package's keys (pos, vel, mass,
acc, step), so either package restores the other's; the
``torch.save``/``torch.load`` pair stands where the JAX package has its
Orbax pair.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.native import runtime as _native
from nbody_tpu_torch.state import ParticleState, default_device


def _numpy64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def dump_state_text(path: str, state: ParticleState, cfg: SimConfig,
                    n_steps: int, positions_only: bool = False) -> None:
    """Write the legacy text dump (header of output_bh.txt:1-4);
    positions_only writes `x y z` rows, as the first-generation nbody.exe
    did."""
    pos = _numpy64(state.pos)
    header = (
        "# Barnes-Hut N-Body Simulation Results\n"
        f"# Final positions and velocities after {n_steps} steps\n"
        f"# Bodies: {state.n}, Theta: {cfg.theta:.2f}, dt: {cfg.dt:.3f}\n"
        "# Format: x y z vx vy vz"
    )
    if positions_only:
        data = pos
        header = header.replace(" vx vy vz", "").replace(
            "positions and velocities", "positions")
    else:
        data = np.concatenate([pos, _numpy64(state.vel)], axis=1)
    if _native.available():
        _native.write_dump(path, header, data)
        return
    warnings.warn(f"{_native.status()}; writing {path} with numpy",
                  RuntimeWarning, stacklevel=2)
    np.savetxt(path, data, fmt="%.6f", header=header, comments="")


def load_dump(path: str) -> Tuple[dict, np.ndarray]:
    """Parse a legacy-format dump (ours or the reference's output_bh.txt):
    (meta, float64 rows), meta from the '# Bodies: N, Theta: T, dt: D'
    header line when present."""
    meta = {}
    with open(path) as f:
        lines = f.readlines()
    body_start = 0
    for i, line in enumerate(lines):
        if not line.startswith("#"):
            body_start = i
            break
        if "Bodies:" in line:
            parts = line.lstrip("# ").replace(",", "").split()
            for k, key in (("Bodies:", "bodies"), ("Theta:", "theta"),
                           ("dt:", "dt")):
                if k in parts:
                    meta[key] = float(parts[parts.index(k) + 1])
    rows = np.loadtxt(lines[body_start:], dtype=np.float64)
    return meta, rows


def save_checkpoint(path: str, state: ParticleState, step: int = 0) -> None:
    """npz with the JAX package's keys and dtypes (float32 arrays)."""
    pos, vel, mass, acc = (x.detach().cpu().numpy() for x in state)
    np.savez(path, pos=pos, vel=vel, mass=mass, acc=acc,
             step=np.asarray(step))


def load_checkpoint(path: str, device=None) -> Tuple[ParticleState, int]:
    """(state, step) from an npz checkpoint of either package; the state
    lies on `device` (CUDA unless asked otherwise)."""
    device = default_device(device)
    with np.load(path) as z:
        state = ParticleState.create(z["pos"], z["vel"], z["mass"], z["acc"],
                                     device=device)
        return state, int(z["step"])


def save_checkpoint_torch(path: str, state: ParticleState,
                          step: int = 0) -> None:
    """torch.save of the same fields (the port's counterpart of the JAX
    package's Orbax checkpoint); tensors are saved from the host."""
    torch.save({"pos": state.pos.cpu(), "vel": state.vel.cpu(),
                "mass": state.mass.cpu(), "acc": state.acc.cpu(),
                "step": int(step)}, path)


def load_checkpoint_torch(path: str, device=None) -> Tuple[ParticleState, int]:
    """(state, step) from save_checkpoint_torch's file, on `device` (CUDA
    unless asked otherwise).  Loads tensors only (weights_only)."""
    device = default_device(device)
    z = torch.load(path, map_location="cpu", weights_only=True)
    state = ParticleState.create(z["pos"], z["vel"], z["mass"], z["acc"],
                                 device=device)
    return state, int(z["step"])
