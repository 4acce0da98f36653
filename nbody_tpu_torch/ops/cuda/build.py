"""Build and load the CUDA force kernels (nbody_tpu_torch/csrc/forces.cu).

``nvcc`` compiles the source into a shared library with a plain C
interface under ``nbody_tpu_torch/build/`` at first use; the file name
carries a hash of the source, so an edited source builds anew and a
built one is reused.  ``load`` opens it with ctypes and declares every
entry point's argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "forces.cu"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no fused multiply-adds: each force term rounds as the plain PyTorch
# version rounds it (see the numerics note in csrc/forces.cu)
NUMERIC_FLAGS = ["-fmad=false"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # pos, n, com, gmass, s_cap, n_live, soft, acc, stream
    "nbody_far_sweep": [_P, _I, _P, _P, _I, _P, _F, _P, _P],
    # pos, tiles, b, tx, ty, tz, tm, rows, near_cnt, row_cnt, near_cap,
    # soft, acc, stream
    "nbody_table_sweep": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _F,
                          _P, _P],
    # tgt, tiles, b, src_pos, src_mass, n_src, win_first, win_mask,
    # win_cnt, w_cap, g, soft, acc, stream
    "nbody_near_span": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _F, _F, _P,
                        _P],
}

_lib = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def library_path() -> Path:
    flags = " ".join(ARCH_FLAGS + NUMERIC_FLAGS).encode()
    digest = hashlib.sha256(SOURCE.read_bytes() + flags).hexdigest()[:16]
    return BUILD_DIR / f"libnbody_forces_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source's library exists; returns
    its path.  `verbose` prints ptxas' register and shared-memory report
    to stderr."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *ARCH_FLAGS, *NUMERIC_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, file=sys.stderr, end="")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
