"""ctypes bindings of the native host runtime (built on first use).

``available()`` says whether the library built and loaded and
``status()`` says why not; every other entry point raises the build's
error when it did not."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from nbody_tpu_torch.native import build as _build

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


def _load() -> ctypes.CDLL:
    """The loaded library; raises RuntimeError (the same one on every
    call after a failed build)."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    try:
        lib = ctypes.CDLL(str(_build.build()))
    except (RuntimeError, OSError) as e:
        _ERROR = f"native runtime unavailable: {e}"
        raise RuntimeError(_ERROR) from e

    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.nbt_msvc_rand_fill.argtypes = [ctypes.c_uint32, ctypes.c_int64, u16p]
    lib.nbt_msvc_rand_fill.restype = None
    lib.nbt_disk_galaxy_ic.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                       ctypes.c_float] + [f32p] * 7
    lib.nbt_disk_galaxy_ic.restype = None
    lib.nbt_write_dump.argtypes = [ctypes.c_char_p, ctypes.c_char_p, f64p,
                                   ctypes.c_int64, ctypes.c_int64]
    lib.nbt_write_dump.restype = ctypes.c_int
    lib.nbt_load_dump.argtypes = [ctypes.c_char_p, f64p, ctypes.c_int64,
                                  ctypes.c_int64]
    lib.nbt_load_dump.restype = ctypes.c_int64
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
    except RuntimeError:
        return False
    return True


def status() -> str:
    """'available (<library path>)' or the build's error."""
    if available():
        return f"available ({_build.library_path()})"
    return str(_ERROR)


def msvc_rand(seed: int, count: int) -> np.ndarray:
    """First `count` outputs of MSVC rand() after srand(seed), uint16."""
    out = np.empty(count, np.uint16)
    _load().nbt_msvc_rand_fill(seed & 0xFFFFFFFF, count, out)
    return out


def disk_galaxy_ic(seed: int, n: int, g: float):
    """The v5 disk galaxy: (pos [n, 3], vel [n, 3], mass [n]) float32."""
    arrs = [np.empty(n, np.float32) for _ in range(7)]
    _load().nbt_disk_galaxy_ic(seed & 0xFFFFFFFF, n, g, *arrs)
    px, py, pz, vx, vy, vz, mass = arrs
    return (np.stack([px, py, pz], axis=1), np.stack([vx, vy, vz], axis=1),
            mass)


def write_dump(path: str, header: str, data: np.ndarray) -> None:
    """`header`, a newline, then one row of `data` per line at %.6f."""
    data = np.ascontiguousarray(data, np.float64)
    rc = _load().nbt_write_dump(path.encode(), header.encode(), data,
                                data.shape[0], data.shape[1])
    if rc != 0:
        raise IOError(f"nbt_write_dump failed for {path}")


def load_dump(path: str, max_rows: int, cols: int) -> np.ndarray:
    """Up to `max_rows` numeric rows of `cols` values ('#' lines
    skipped)."""
    out = np.empty((max_rows, cols), np.float64)
    n = _load().nbt_load_dump(path.encode(), out, max_rows, cols)
    if n < 0:
        raise IOError(f"nbt_load_dump failed for {path}")
    return out[:n]
