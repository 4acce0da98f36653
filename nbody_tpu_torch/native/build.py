"""Build the native host runtime (src/runtime.cc) with g++.

    python -m nbody_tpu_torch.native.build

The shared library goes to ``nbody_tpu_torch/build/`` (git-ignored) under
a name that carries a hash of the source and the flags, so an edited
source builds anew and a built one is reused.  It is built for a generic
x86-64 or ARM host (no -march=native): the build directory may be copied
to another machine.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "src" / "runtime.cc"
BUILD_DIR = _PKG / "build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnbt_runtime_{digest}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; returns its
    path.  Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {e}") from e
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name} ({done.returncode}):\n"
                           f"{done.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
