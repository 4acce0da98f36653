"""The plain reference of the benchmark's check: Newtonian gravity summed
over every pair, in plain PyTorch, with the upstream v5 force law

    a_i = G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + soft)^(3/2)

(SOFTENING added to the squared distance, nbody_v5.cu; the self term adds
exactly zero).  It imports nothing of the program and takes nothing that
the program made but the positions it is asked about.

`accelerations` runs in float64 for the reference and in bfloat16 for
the control, the same code at the precision below the program's
float32: every operand and every operation in that dtype, each block's
sum rounded to it and the blocks summed in it.
"""

from __future__ import annotations

import torch

# elements of one [targets, sources] block; a few such blocks live at once
_BLOCK_ELEMS = 1 << 25


def accelerations(tgt: torch.Tensor, src: torch.Tensor, mass: torch.Tensor,
                  g: float, soft: float, dtype=torch.float64,
                  tgt_block: int = 1024) -> torch.Tensor:
    """[T, 3] accelerations at the target positions `tgt` [T, 3] from the
    sources (`src` [N, 3], `mass` [N]), computed in `dtype`, in blocks of
    targets and sources."""
    tgt, src = tgt.to(dtype), src.to(dtype)
    gm = (g * mass.to(torch.float64)).to(dtype)
    soft_t = torch.tensor(soft, dtype=dtype, device=src.device)
    src_block = max(1, _BLOCK_ELEMS // tgt_block)
    out = []
    for i in range(0, tgt.shape[0], tgt_block):
        t = tgt[i:i + tgt_block]
        acc = torch.zeros_like(t)
        for j in range(0, src.shape[0], src_block):
            d = src[None, j:j + src_block, :] - t[:, None, :]   # [B, S, 3]
            d2 = (d * d).sum(dim=2, dtype=dtype)
            inv = torch.rsqrt(d2 + soft_t)
            w = gm[None, j:j + src_block] * (inv * inv * inv)
            acc = acc + (w[:, :, None] * d).sum(dim=1, dtype=dtype)
        out.append(acc)
    return torch.cat(out)
