"""Build and load the CUDA kernel libraries (nbody_tpu_torch/csrc/*.cu).

Each library is one source compiled by ``nvcc`` into a shared library
with a plain C interface under ``nbody_tpu_torch/build/`` at first use;
the file name carries a hash of the source and its flags, so an edited
source builds anew and a built one is reused.  ``load`` opens it with
ctypes and declares every entry point's argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple

_PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Library(NamedTuple):
    source: Path
    flags: List[str]
    signatures: Dict[str, list]


LIBRARIES = {
    "tile_sweeps": Library(
        _PKG / "csrc" / "tile_sweeps.cu",
        [],
        {
            # pos, n, com, gmass, s_cap, n_live (int64), soft, acc, blocks,
            # stream
            "nbody_far_sweep": [_P, _I, _P, _P, _I, _P, _F, _P, _I, _P],
            # pos, tiles, b, tx, ty, tz, tm, rows, near_cnt, row_cnt,
            # near_cap, order, soft, acc, stream
            "nbody_table_sweep": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I,
                                  _P, _F, _P, _P],
            # tgt, tiles, b, src_pos, src_mass, n_src, win_first, win_mask,
            # win_cnt, w_cap, order, g, soft, acc, stream
            "nbody_near_span": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _P,
                                _F, _F, _P, _P],
            # lo, hi (float bit patterns), bad (uint64 count), stream
            "nbody_inv_sqrt_check": [ctypes.c_uint, ctypes.c_uint, _P, _P],
            # x, n, out, stream
            "nbody_inv_sqrt_eval": [_P, _I, _P, _P],
        }),
    "band_classify": Library(
        _PKG / "csrc" / "band_classify.cu",
        [],
        {
            # args (a ClassifyArgs, ops/cuda/classify.py), stream
            "nbody_band_classify": [_P, _P],
        }),
    "band_tables": Library(
        _PKG / "csrc" / "band_tables.cu",
        [],
        {
            # args (a TablesArgs, ops/cuda/tables.py), stream
            "nbody_band_tables": [_P, _P],
        }),
    "panel": Library(
        _PKG / "csrc" / "panel.cu",
        [],
        {
            # variant, pos3, tiles, gx, gy, gz, gm, n_src, soft, out, stream
            "nbody_panel_sweep": [_I, _P, _I, _P, _P, _P, _P, _I, _F, _P, _P],
        }),
}

_loaded: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    lib = LIBRARIES[name]
    flags = " ".join(ARCH_FLAGS + lib.flags).encode()
    digest = hashlib.sha256(lib.source.read_bytes() + flags).hexdigest()[:16]
    return BUILD_DIR / f"libnbody_{name}_{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile one library unless its source's build exists; returns its
    path.  `verbose` prints ptxas' register and shared-memory report to
    stderr."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    lib = LIBRARIES[name]
    cmd = [nvcc(), *ARCH_FLAGS, *lib.flags, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(lib.source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({done.returncode}):\n"
                           f"{done.stderr}")
    if verbose:
        print(done.stderr, file=sys.stderr, end="")
    os.replace(tmp, out)
    return out


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Build every library, one nvcc each."""
    return {name: build(name, verbose) for name in LIBRARIES}


def load(name: str) -> ctypes.CDLL:
    """One loaded kernel library (built on first call)."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, argtypes in LIBRARIES[name].signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
