"""The escape-linearised octree of the rope-walk oracle.

1.  A Karras binary radix tree over the sorted 30-bit Morton codes: each
    internal node is a sorted-index range [first, last], found by a
    vectorised binary search on longest-common-prefix lengths.  Equal
    codes are told apart by their sorted position (the augmented key
    (code << 32) | position).
2.  Node mass and centre of mass from compensated prefix sums over the
    sorted particles: mass(node) = P[last+1] - P[first].
3.  A DFS-preorder linearisation with escape indices ("ropes"): preorder
    of a laminar family of ranges is the order by (first ascending,
    length descending), one sort.  A walk needs no stack: accept a node
    -> jump to its escape index, open it -> step to +1.

The cell width of a node comes from the common Morton prefix of its
range: codes sharing 3d bits lie in one depth-d cell of width
root_size / 2^d.

Integers are int64 throughout (the JAX package's uint32/int32 fields hold
the same values).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nbody_tpu_torch.ops import compensated as comp
from nbody_tpu_torch.ops.cells import bit_length

_I64 = torch.int64


class LinearTree(NamedTuple):
    """Escape-linearised tree, padded to 2N entries (2N-1 real nodes).

    Entry k's first child is k+1 and `escape[k]` is the preorder index
    just past k's subtree.  Leaves carry the particle itself (width 0,
    com = position), so a walk has one accept rule, width / dist < theta,
    and a particle's own leaf adds exactly zero.  The last entry is inert
    (mass 0, width 0, escape past the end)."""

    com: torch.Tensor      # [2N, 3] float32, centre of mass (leaf: position)
    mass: torch.Tensor     # [2N]    float32, subtree mass
    width: torch.Tensor    # [2N]    float32, containing cell width (leaf: 0)
    escape: torch.Tensor   # [2N]    int64, preorder index past the subtree
    first: torch.Tensor    # [2N]    int64, sorted-particle range start
    last: torch.Tensor     # [2N]    int64, sorted-particle range end (incl.)
    parent: torch.Tensor   # [2N]    int64, preorder parent (-1 root / pad)

    @property
    def n_nodes(self) -> int:
        """Real node count 2N-1."""
        return self.com.shape[0] - 1

    @property
    def n_particles(self) -> int:
        return self.com.shape[0] // 2


def _clz(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of 32-bit unsigned values held in int64
    (32 for 0), as lax.clz on uint32."""
    return 32 - bit_length(x & 0xFFFFFFFF)


def _delta(mc: torch.Tensor, n: int, i: torch.Tensor,
           j: torch.Tensor) -> torch.Tensor:
    """LCP length between the augmented keys at sorted positions i and j:
    equal codes fall through to the position bits (32 + clz(i ^ j));
    out-of-range j gives -1, below any real LCP."""
    valid = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    a = mc[i]
    b = mc[jc]
    d = torch.where(a == b, 32 + _clz(i ^ jc), _clz(a ^ b))
    return torch.where(valid, d, torch.full_like(d, -1))


def _internal_ranges(mc: torch.Tensor, n: int):
    """For internal node i in [0, n-2], the sorted index range
    [first, last] it covers: LCP along the sorted order is monotone, so
    the extent is one binary search."""
    i = torch.arange(n - 1, dtype=_I64, device=mc.device)
    d_next = _delta(mc, n, i, i + 1)
    d_prev = _delta(mc, n, i, i - 1)
    d = torch.where(d_next > d_prev, 1, -1)
    delta_min = torch.minimum(d_next, d_prev)
    l = torch.zeros_like(i)
    for k in range(max(1, math.ceil(math.log2(n))), -1, -1):
        cand = l + (1 << k)
        go = _delta(mc, n, i, i + cand * d) > delta_min
        l = torch.where(go, cand, l)
    j = i + l * d
    return torch.minimum(i, j), torch.maximum(i, j)


def _cell_width(mc: torch.Tensor, first: torch.Tensor, last: torch.Tensor,
                root_size: torch.Tensor) -> torch.Tensor:
    """Width of the tightest octree cell holding a code range: 30-bit
    codes share clz(a ^ b) - 2 code bits, 3 bits per level; equal codes
    sit in a depth-10 cell."""
    a = mc[first]
    b = mc[last]
    prefix_bits = torch.where(a == b, 30, _clz(a ^ b) - 2)
    depth = torch.div(prefix_bits, 3, rounding_mode="floor")
    return root_size * torch.exp2(-depth.to(torch.float32))


def build_tree(mc_sorted: torch.Tensor, pos_sorted: torch.Tensor,
               mass_sorted: torch.Tensor,
               root_size: torch.Tensor) -> LinearTree:
    """Build the escape-linearised Barnes-Hut tree from [N] sorted 30-bit
    codes (int64), [N, 3] positions and [N] masses in the same order and
    the cubified bounding box side.  Requires N >= 2."""
    n = mc_sorted.shape[0]
    if n < 2:
        raise ValueError("build_tree requires at least 2 particles")
    dev = mc_sorted.device
    mc = mc_sorted.to(_I64)
    m_nodes = 2 * n - 1

    first_int, last_int = _internal_ranges(mc, n)
    leaf_idx = torch.arange(n, dtype=_I64, device=dev)
    first_all = torch.cat([first_int, leaf_idx])
    last_all = torch.cat([last_int, leaf_idx])

    # DFS preorder: by (first asc, length desc); the pairs are unique
    length = last_all - first_all + 1
    _, p = torch.sort(first_all * n + (n - length), stable=True)
    inv = torch.empty_like(p)
    inv[p] = torch.arange(m_nodes, dtype=_I64, device=dev)
    leaf_pre = inv[n - 1 + leaf_idx]          # preorder position of leaf j

    ph_m, pl_m = comp.prefix_sums(mass_sorted)
    mass_int = comp.range_sum(ph_m, pl_m, first_int, last_int)
    wpos = pos_sorted * mass_sorted[:, None]
    msum = torch.stack([comp.range_sum(*comp.prefix_sums(wpos[:, c]),
                                       first_int, last_int)
                        for c in range(3)], dim=1)
    # divide only where mass > 1e-6 (finalizeCOMKernel, nbody_v5.cu:205)
    safe = mass_int > 1e-6
    com_int = torch.where(safe[:, None],
                          msum / mass_int.clamp(min=1e-6)[:, None],
                          torch.zeros_like(msum))
    root = torch.as_tensor(root_size, dtype=torch.float32, device=dev)
    width_int = _cell_width(mc, first_int, last_int, root)

    com_all = torch.cat([com_int, pos_sorted])
    mass_all = torch.cat([mass_int, mass_sorted])
    width_all = torch.cat([width_int, width_int.new_zeros(n)])

    pre_first = first_all[p]
    pre_last = last_all[p]
    pre_escape = leaf_pre[pre_last] + 1

    # parents by scattering from children: in preorder an internal node
    # k's children are k+1 and escape[k+1]; row m_nodes takes the leaves'
    ks = torch.arange(m_nodes, dtype=_I64, device=dev)
    internal = pre_first < pre_last
    c1 = torch.where(internal, ks + 1, m_nodes)
    c2 = torch.where(internal, pre_escape[(ks + 1).clamp(max=m_nodes - 1)],
                     m_nodes)
    parent = torch.full((m_nodes + 1,), -1, dtype=_I64, device=dev)
    parent[c1] = torch.where(internal, ks, -1)
    parent[c2] = torch.where(internal, ks, -1)

    def pad(x, value):
        return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), value)])

    return LinearTree(
        com=pad(com_all[p], 0.0),
        mass=pad(mass_all[p], 0.0),
        width=pad(width_all[p], 0.0),
        escape=pad(pre_escape, m_nodes + 1),
        first=pad(pre_first, 0),
        last=pad(pre_last, 0),
        parent=pad(parent[:m_nodes], -1),
    )
