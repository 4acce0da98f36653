"""Instructions a pair in each force and panel kernel's pair loop, from the
machine code of the built libraries.

    python -m nbody_tpu_torch.tools.sass

Builds the kernel libraries (ops/cuda/build.py) where they are not built
yet, disassembles each with ``cuobjdump -sass`` from the CUDA toolkit
beside nvcc, and prints one line per kernel of KERNELS: its pair loop
(the backward branch whose body holds the most MUFU operations), the
instructions in it per pair (each pair takes one MUFU.RSQ) and the
opcodes most issued per pair.  Instructions a pair over 128 lanes per SM
per clock bound a kernel that the issue rate limits.  Needs the CUDA
toolkit, not a card.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from nbody_tpu_torch.ops.cuda import build

# kernel: (library, fragment of its mangled name)
KERNELS = {
    "far_sweep": ("tile_sweeps", "far_sweep_kernel"),
    "table_sweep<4>": ("tile_sweeps", "table_sweep_kernelILi4E"),
    "near_span<4>": ("tile_sweeps", "near_span_kernelILi4E"),
    "panel_vpu": ("panel", "panel_sweep_kernelILi0E"),
    "panel_mxu": ("panel", "panel_sweep_kernelILi1E"),
    "panel_mxu_c": ("panel", "panel_sweep_kernelILi2E"),
}


def functions(dump: str) -> dict:
    """Each function of a `cuobjdump -sass` listing by its mangled name."""
    out = {}
    for part in dump.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def pair_loop(func: str) -> list:
    """The instructions of `func`'s backward branch whose body holds the
    most MUFU operations, predicates stripped."""
    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", op.strip()))
           for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    loops = [(int(t, 16), a) for a, op in ins
             for t in re.findall(r"BRA\s.*?0x([0-9a-f]+)", op)
             if int(t, 16) < a]
    if not loops:
        raise ValueError("no backward branch")
    return max(([op for a, op in ins if lo <= a <= hi] for lo, hi in loops),
               key=lambda body: sum("MUFU" in op for op in body))


def per_pair(body: list) -> tuple:
    """(pairs, instructions a pair, {opcode: issued a pair}) of a pair
    loop: one MUFU.RSQ a pair."""
    pairs = sum("MUFU.RSQ" in op for op in body)
    if pairs == 0:
        raise ValueError("the loop holds no MUFU.RSQ")
    ops = collections.Counter(op.split()[0].split(".")[0] for op in body)
    return pairs, len(body) / pairs, {k: v / pairs for k, v in ops.items()}


def main() -> int:
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    funcs = {}
    for lib in sorted({lib for lib, _ in KERNELS.values()}):
        dump = subprocess.run([tool, "-sass", str(build.build(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs[lib] = functions(dump)
    for name, (lib, frag) in KERNELS.items():
        found = [f for f in funcs[lib] if frag in f]
        if len(found) != 1:
            raise RuntimeError(f"{name}: {len(found)} functions of {lib} "
                               f"match {frag!r}")
        pairs, n, ops = per_pair(pair_loop(funcs[lib][found[0]]))
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
        print(f"[sass] {name}: pair loop of {round(n * pairs)} instructions "
              f"for {pairs} pairs, {n:.2f} a pair; "
              + ", ".join(f"{k} {v:.2f}" for k, v in top), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
