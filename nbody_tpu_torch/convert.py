"""Carry particle state and configs across from the JAX package's data.

State goes through numpy (the neutral format both packages read), and a
config through ``dataclasses.asdict`` of ``nbody_tpu.config.SimConfig``
(and back through ``config_to_dict``), so the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from nbody_tpu_torch.config import PORT_ONLY, SimConfig
from nbody_tpu_torch.state import ParticleState


def state_from_numpy(pos, vel, mass, acc=None, device=None) -> ParticleState:
    """numpy (or array-like) pos/vel [N, 3], mass [N] -> ParticleState."""
    return ParticleState.create(np.asarray(pos), np.asarray(vel),
                                np.asarray(mass),
                                None if acc is None else np.asarray(acc),
                                device=device)


def state_to_numpy(state: ParticleState) -> Tuple[np.ndarray, ...]:
    """Inverse of state_from_numpy: (pos, vel, mass, acc) float32 arrays."""
    return tuple(x.detach().cpu().numpy() for x in state)


def config_from_dict(d: Dict) -> SimConfig:
    """SimConfig from ``dataclasses.asdict`` of the JAX package's config
    (field names are identical; unknown fields raise)."""
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    kw = dict(d)
    if "mesh_shape" in kw:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return SimConfig(**kw)


def config_to_dict(cfg: SimConfig) -> Dict:
    """The fields of `cfg` that the JAX package's config has (all but
    config.PORT_ONLY), for ``nbody_tpu.config.SimConfig(**...)``."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in PORT_ONLY}
