"""Probe of the far-sweep panel written three ways (port of
tools/_prof_mxu.py).

    python -m nbody_tpu_torch.tools.prof_mxu [--targets N] [--sources G]
                                             [--device cuda]

The panels (vpu, mxu, mxu_c) and their plain sweep are in
``nbody_tpu_torch.ops.panel``; the CUDA kernel is csrc/panel.cu through
ops/cuda/panel.py.  `run` (the entry point's body) makes the inputs from
a fixed seed, runs the three kernel variants, times each with CUDA events
(two warm-up and ITERS timed launches) and reports the vpu-vs-mxu and
vpu-vs-mxu_c differences, as the JAX tool does.  The default shape is the
JAX tool's: 2^20 targets as [4096, 256, 3] and 8192 sources (8.6e9
pairs).
"""

from __future__ import annotations

import argparse
import sys

import torch

from nbody_tpu_torch.ops.cuda import panel as kern
from nbody_tpu_torch.ops.panel import B, LC, VARIANTS

ITERS = 8


def make_inputs(n_targets: int, n_sources: int, device):
    """(pos3 [n_targets/B, B, 3], gx, gy, gz, gm): coordinates uniform in
    [-1700, 1700), masses in [1, 7), from a torch.Generator with seed 0."""
    if n_targets % B or n_sources % LC:
        raise ValueError(f"targets must be a multiple of {B} and sources "
                         f"of {LC}")
    gen = torch.Generator(device=device).manual_seed(0)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    pos3 = uniform((n_targets // B, B, 3), -1700.0, 1700.0)
    gx, gy, gz = (uniform((n_sources,), -1700.0, 1700.0) for _ in range(3))
    return pos3, gx, gy, gz, uniform((n_sources,), 1.0, 7.0)


def max_rel_diff(ra: torch.Tensor, rb: torch.Tensor) -> float:
    """max over targets of |ra - rb| / (|ra| + 1e-6), the JAX tool's."""
    return float(((ra - rb).norm(dim=-1) / (ra.norm(dim=-1) + 1e-6)).max())


def run(n_targets: int = 1 << 20, n_sources: int = 8192, device="cuda",
        log=print):
    """Each variant through the kernel wrapper: one call for its output,
    then (on CUDA) two warm-up launches and ITERS launches timed with
    CUDA events.  Returns {"inputs", "out": {variant: [t, B, 3]},
    "ms": {variant: mean ms, None on the CPU}, "diff": {"mxu", "mxu_c":
    max rel diff against vpu}}."""
    device = torch.device(device)
    inputs = make_inputs(n_targets, n_sources, device)
    pairs = n_targets * n_sources
    out, ms = {}, {}
    for name in VARIANTS:
        out[name] = kern.sweep(name, *inputs)
        ms[name] = None
        if device.type == "cuda":
            for _ in range(2):
                kern.sweep(name, *inputs)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(ITERS):
                kern.sweep(name, *inputs)
            end.record()
            torch.cuda.synchronize(device)
            ms[name] = start.elapsed_time(end) / ITERS
            log(f"{name}: {ms[name]:.3f} ms -> "
                f"{pairs / ms[name] * 1e3 / 1e9:.0f} G pairs/s")
    diff = {name: max_rel_diff(out["vpu"], out[name])
            for name in ("mxu", "mxu_c")}
    for name, rel in diff.items():
        log(f"max rel diff vpu-vs-{name}: {rel:.2e}")
    return {"inputs": inputs, "out": out, "ms": ms, "diff": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--targets", type=int, default=1 << 20)
    ap.add_argument("--sources", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; times the kernels) or cpu (plain "
                         "versions, no timing)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("prof_mxu: no CUDA device (pass --device cpu for the "
                  "plain versions)", file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(args.device)}")
    run(args.targets, args.sources, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
