"""A/B of the near windows' pack stage (port of tools/_prof_winmask.py):
the port's forces._window_masks against the JAX tool's older formulation,
on classify-shaped runs, chunked over rows as the classifier chunks them.

    python -m nbody_tpu_torch.tools.prof_winmask [rows] [k] [win_cap]
                                                 [--device cuda]

A ("segmented sum") is forces._window_masks: the pieces' lane masks
summed per window rank by one index_add_ (merged pieces cover disjoint
lanes, so the sum is the OR).  B ("sort + gathers") is the JAX tool's
older 5-operand formulation: a segmented OR that leaves each window's
mask at its last piece (here a cumsum less the sum before the window's
first piece), then a stable sort of the keep key with the four mask
words gathered along it.  Both take 2 pieces a run (the generator's runs
are at most 59 long) and their outputs must be identical.

The runs are the JAX tool's draws from np.random.default_rng(0): 60-199
runs a row of 4-59 particles with gaps of 1-49, in rows of [k] slots, so
k must be at least 200 (the JAX generator fails below it).  They are laid
out as the JAX tool's comment intends, ascending and disjoint (run i
starts its gap after run i-1 ends), which is _window_masks' contract.
The JAX tool lays run i at cumsum(lens + gaps)[i] instead, which overlaps
run i-1 wherever len_i + gap_i < len_(i-1) (every row of its default
draw): there the window keys fall back, a window repeats
out of order and the lane masks of two runs overlap, where an OR and a
sum of them part.

Each time is the mean of 6 calls after one (CUDA events on the card,
the host's median on the CPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nbody_tpu_torch.ops.forces import SPAN_ALIGN, _BIG, _I32, _I64, \
    _pieces, _window_masks
from nbody_tpu_torch.tools import common

K_MIN = 200           # the generator draws up to 199 runs a row
CH = 256              # rows a chunk (the classifier's chunk bound)
PIECES = 2


def runs(rows: int, k: int, seed: int = 0):
    """(first, count) int32 [rows, k]: the JAX tool's generator."""
    if k < K_MIN:
        raise ValueError(f"k={k}: the generator draws up to {K_MIN - 1} runs "
                         f"a row, so k must be at least {K_MIN}")
    rng = np.random.default_rng(seed)
    cnt_live = rng.integers(60, 200, size=rows)
    first = np.zeros((rows, k), np.int32)
    count = np.zeros((rows, k), np.int32)
    for i in range(rows):
        c = cnt_live[i]
        rng.choice(900_000, size=c, replace=False)   # drawn and unused, as
        lens = rng.integers(4, 60, size=c)           # in the JAX tool
        gaps = rng.integers(1, 50, size=c)
        first[i, :c] = np.cumsum(lens + gaps) - lens
        count[i, :c] = lens
    return first, count



def win_sort(first: torch.Tensor, count: torch.Tensor, win_cap: int,
             pieces: int):
    """B: forces._window_masks' contract by a segmented OR left at each
    window's last piece and a stable sort of the keep key, the mask words
    gathered along it."""
    big = _BIG
    p = pieces
    f, c = first.to(_I64), count.to(_I64)
    key, ms = _pieces(f, c, p, big)                   # [R, W], [R, W, 4]
    width = key.shape[1]
    out_cap = min(win_cap, width)
    bnd = torch.cat([torch.ones_like(key[:, :1], dtype=torch.bool),
                     key[:, 1:] != key[:, :-1]], dim=1)
    rank = torch.cumsum(bnd.to(_I64), dim=1) - 1
    child_live = c > 0
    child_drop = child_live & (rank[:, p - 1::p] >= win_cap)
    kept = (child_live & ~child_drop).sum(dim=1)
    dropped = child_drop.any(dim=1)
    words = torch.where(child_drop.repeat_interleave(p, dim=1)[..., None], 0,
                        ms.to(_I64) & 0xFFFFFFFF)
    run_sum = torch.cumsum(words, dim=1)
    lane = torch.arange(width, device=key.device)
    start = torch.cummax(torch.where(bnd, lane, 0), dim=1).values
    before = torch.gather(run_sum, 1, torch.clamp(start - 1, min=0)[
        ..., None].expand(-1, -1, 4))
    seg = run_sum - torch.where((start > 0)[..., None], before, 0)
    last = torch.cat([key[:, :-1] != key[:, 1:],
                      torch.ones_like(key[:, :1], dtype=torch.bool)], dim=1)
    keep = torch.where(last & (key < big) & (rank < win_cap), key, big)
    keep, order = torch.sort(keep, dim=1, stable=True)
    keep, order = keep[:, :out_cap], order[:, :out_cap]
    m = torch.gather(seg, 1, order[..., None].expand(-1, -1, 4))
    live = keep < big
    win_first = torch.where(live, keep * SPAN_ALIGN, 0).to(_I32)
    m = torch.where(live[..., None], m, 0)
    m = torch.where(m >= 1 << 31, m - (1 << 32), m)          # as int32
    return (win_first, m.permute(0, 2, 1).to(_I32).contiguous(),
            live.sum(dim=1), kept, dropped)


def chunked(fn, first, count, win_cap, pieces=PIECES):
    parts = [fn(first[i:i + CH], count[i:i + CH], win_cap, pieces)
             for i in range(0, first.shape[0], CH)]
    return tuple(torch.cat(x) for x in zip(*parts))


FORMS = {"segmented sum (_window_masks)": _window_masks,
         "sort + gathers (old)": win_sort}


def ab(first: torch.Tensor, count: torch.Tensor, win_cap: int = 128,
       iters: int = 6) -> dict:
    """{"ms": {formulation: ms}, "outputs": {formulation: (win_first,
    win_mask, win_cnt, kept_children, dropped)}}; raises if the two
    formulations' outputs differ."""
    ms, outs = {}, {}
    for label, fn in FORMS.items():
        outs[label] = chunked(fn, first, count, win_cap)
        ms[label] = common.device_ms(
            lambda fn=fn: chunked(fn, first, count, win_cap), first.device,
            iters)
    a, b = outs.values()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError("the two pack-stage formulations differ")
    return {"ms": ms, "outputs": outs}


def report(r: dict) -> str:
    return "\n".join([f"{k:30s} {v:8.2f} ms" for k, v in r["ms"].items()]
                     + ["outputs identical"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", type=int, default=4096)
    ap.add_argument("k", nargs="?", type=int, default=1024)
    ap.add_argument("win_cap", nargs="?", type=int, default=128)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    first, count = (torch.from_numpy(x).to(dev)
                    for x in runs(args.rows, args.k))
    print(f"[winmask] rows={args.rows} k={args.k} win_cap={args.win_cap} "
          f"({dev.type})", flush=True)
    print(report(ab(first, count, args.win_cap)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
