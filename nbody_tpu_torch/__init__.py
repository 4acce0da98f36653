"""nbody_tpu_torch — the PyTorch/CUDA port of nbody_tpu.

The per-step Barnes-Hut pipeline of nbody_tpu (Morton sort, adaptive
octree cells, band classification, per-tile tables) in PyTorch, with the
three Pallas force kernels rewritten as hand CUDA kernels for Hopper
(csrc/forces.cu).  Module names mirror nbody_tpu's.  Runs on the GPU by
default; the CPU runs the kernels' plain PyTorch versions.  Imports
neither JAX nor nbody_tpu.
"""

from nbody_tpu_torch.config import SimConfig, PRESETS
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch import init
from nbody_tpu_torch.models.simulation import Simulation

__version__ = "0.1.0"

__all__ = ["SimConfig", "PRESETS", "ParticleState", "Simulation", "init",
           "__version__"]
