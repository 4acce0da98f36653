"""The work the force kernels of nbody_tpu_torch have to do, and the
card's peaks that bound it: the yardstick of the benchmark's roofline
shares, kept here so that no change to the program can change it.

A frozen copy of the live-pair and byte arithmetic of
``nbody_tpu_torch.bench.work`` (and of ``tools.prof_nearwin.live_lanes``)
as it stood when the benchmark was written.  Only the work that the
inputs need is counted: live pairs, each input byte read once and each
output byte written once, never the pairs a kernel executes for its own
padding.  ``benchmark/tests/test_harness_work.py`` holds it equal to the
port's count at that commit.
"""

from __future__ import annotations

from typing import Dict

import torch

# NVIDIA H100 SXM published peaks at the full 700 W power limit: float32
# outside the tensor cores, and HBM3 bandwidth.  The harness reports the
# card's power limit beside every share of them.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_POWER_W = 700.0
# 3 sub, 3 mul + 3 add (d2 + soft), sqrt, division, 3 mul (m * inv^3),
# 3 mul + 3 add (the terms and their sums), one operation each
FLOPS_PER_PAIR = 20


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(v)
    for k in range(32):
        n += (v >> k) & 1
    return n


def live_lanes(bands) -> int:
    """Set mask bits over each tile's first win_cnt windows, summed: the
    source lanes of the near band."""
    wc = bands.win_cnt.to(torch.int64)
    lane_ok = torch.arange(bands.win_first.shape[1],
                           device=wc.device) < wc[:, None]
    return int((popcount32(bands.win_mask) * lane_ok[:, None, :]).sum())


def work(force_tile: int, near_cap: int, ps, ss, bands, tables,
         n_src=None) -> Dict:
    """Per force kernel, the work of one launch on these band structures:
    {"live": live pairs, "bytes": inputs read once and outputs written
    once}.  `ps` are the padded sorted target positions, `ss` the far
    sweep's sources, `bands` and `tables` the band build's lists; n_src
    is the near sweep's source rows (default: the targets).

    Live pairs: far n_pad x n_supers; table tile x sum(near_cnt + row_cnt
    - near_cap); near tile x the set mask bits of each tile's first
    win_cnt windows."""
    n, b = ps.shape[0], force_tile
    n_src = n if n_src is None else n_src
    t = n // b
    n_live = int(ss.n_supers)
    near_cnt = bands.near_cnt.to(torch.int64)
    row_cnt = tables.row_cnt.to(torch.int64)
    live_rows = int((near_cnt + row_cnt - near_cap).sum())
    lanes = live_lanes(bands)
    windows = int(bands.win_cnt.sum())
    return {
        "far_sweep": {"live": n * n_live,
                      "bytes": 24 * n + 16 * n_live + 4},
        "table_sweep": {"live": b * live_rows,
                        "bytes": 24 * n + 16 * live_rows + 8 * t},
        "near_span": {"live": b * lanes,
                      "bytes": 24 * n + 16 * n_src + 20 * windows + 4 * t},
    }


def least_seconds(w: Dict) -> Dict:
    """Per kernel of `work`'s result, the least time the card could take:
    (seconds, "compute" or "memory", whichever bounds it)."""
    out = {}
    for k, v in w.items():
        compute = FLOPS_PER_PAIR * v["live"] / PEAK_FP32
        memory = v["bytes"] / PEAK_BYTES
        out[k] = ((compute, "compute") if compute >= memory
                  else (memory, "memory"))
    return out
