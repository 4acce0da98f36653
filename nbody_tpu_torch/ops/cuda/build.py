"""Build and load the CUDA kernel libraries (nbody_tpu_torch/csrc/*.cu).

Each library is one source compiled by ``nvcc`` into a shared library
with a plain C interface under ``nbody_tpu_torch/build/`` at first use;
the file name carries a hash of the source and its flags, so an edited
source builds anew and a built one is reused.  ``load`` opens it with
ctypes and declares every entry point's argument types; ``build_all``
starts one ``nvcc`` per library, all at once.
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
    "forces": Library(
        _PKG / "csrc" / "forces.cu",
        # no fused multiply-adds: each force term rounds as the plain
        # PyTorch version rounds it (see the numerics note in forces.cu)
        ["-fmad=false"],
        {
            # pos, n, com, gmass, s_cap, n_live, soft, acc, stream
            "nbody_far_sweep": [_P, _I, _P, _P, _I, _P, _F, _P, _P],
            # pos, tiles, b, tx, ty, tz, tm, rows, near_cnt, row_cnt,
            # near_cap, soft, acc, stream
            "nbody_table_sweep": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I,
                                  _F, _P, _P],
            # tgt, tiles, b, src_pos, src_mass, n_src, win_first, win_mask,
            # win_cnt, w_cap, g, soft, acc, stream
            "nbody_near_span": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _F,
                                _F, _P, _P],
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


def _start(name: str):
    """(final path, temp path, nvcc process or None when already built)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    lib = LIBRARIES[name]
    cmd = [nvcc(), *ARCH_FLAGS, *lib.flags, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(lib.source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc, verbose: bool) -> Path:
    if proc is None:
        return out
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{err}")
    if verbose:
        print(err, file=sys.stderr, end="")
    os.replace(tmp, out)
    return out


def build(name: str, verbose: bool = False) -> Path:
    """Compile one library unless its source's build exists; returns its
    path.  `verbose` prints ptxas' register and shared-memory report to
    stderr."""
    return _finish(name, *_start(name), verbose)


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Build every library, one nvcc each, all started together."""
    started = {name: _start(name) for name in LIBRARIES}
    paths, errors = {}, []
    for name, s in started.items():     # wait for every nvcc, then raise
        try:
            paths[name] = _finish(name, *s, verbose)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return paths


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
