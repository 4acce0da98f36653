"""nbody_tpu_torch — the PyTorch/CUDA port of nbody_tpu.

The Barnes-Hut pipeline of nbody_tpu (Morton sort, adaptive octree
cells, band classification, per-tile tables) and its adaptive band-reuse
runner in PyTorch, with every Pallas kernel rewritten as a hand CUDA
kernel for Hopper (csrc/forces.cu: the far sweep; csrc/tile_sweeps.cu:
the table and near-span sweeps; csrc/panel.cu: the panel probe of
tools/_prof_mxu.py), and around it the rope-walk oracle, dumps and
checkpoints, the renderer, the live viewer and the command line
(``python -m nbody_tpu_torch``).  Module names mirror nbody_tpu's.
Runs on the GPU by default; the CPU runs the kernels' plain PyTorch
versions.  Imports neither JAX nor nbody_tpu.
"""

from nbody_tpu_torch.config import SimConfig, PRESETS
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch import init
from nbody_tpu_torch.models.simulation import Simulation

__version__ = "0.1.0"

__all__ = ["SimConfig", "PRESETS", "ParticleState", "Simulation", "init",
           "__version__"]
