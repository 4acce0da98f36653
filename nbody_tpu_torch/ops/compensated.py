"""Two-float ("double-single") compensated arithmetic on float32 tensors.

Node masses and centres of the rope-walk tree come from prefix sums over
the Morton-sorted particles; a plain float32 cumsum over 10^6 bodies
loses about five digits in the small-node differences.  Each prefix is
carried as an unevaluated (hi, lo) float32 pair (Knuth TwoSum, Dekker
renormalisation), about 2^-45 relative accuracy.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Knuth TwoSum: s + e == a + b exactly, |e| <= ulp(s)/2."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Dekker FastTwoSum; requires |a| >= |b| (true after renormalising)."""
    s = a + b
    e = b - (s - a)
    return s, e


def df_add(x: Pair, y: Pair) -> Pair:
    """Add two (hi, lo) pairs, renormalised."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    lo = xl + yl + e
    return fast_two_sum(s, lo)


def df_neg(x: Pair) -> Pair:
    return (-x[0], -x[1])


def df_to_f32(x: Pair) -> torch.Tensor:
    return x[0] + x[1]


def compensated_cumsum(x: torch.Tensor, axis: int = 0) -> Pair:
    """Inclusive cumsum of `x` along `axis` in two-float precision:
    (hi, lo) tensors of x's shape.  A log2(N)-step doubling scan with
    df_add (each step adds the partial sum `shift` places back), so the
    summation order differs from a sequential or tree scan while the
    accuracy is the two-float one."""
    n = x.shape[axis]
    hi, lo = x, torch.zeros_like(x)
    shift = 1
    while shift < n:
        head = (hi.narrow(axis, 0, shift), lo.narrow(axis, 0, shift))
        sh, sl = df_add((hi.narrow(axis, 0, n - shift),
                         lo.narrow(axis, 0, n - shift)),
                        (hi.narrow(axis, shift, n - shift),
                         lo.narrow(axis, shift, n - shift)))
        hi = torch.cat([head[0], sh], dim=axis)
        lo = torch.cat([head[1], sl], dim=axis)
        shift *= 2
    return hi, lo


def prefix_sums(x: torch.Tensor) -> Pair:
    """Exclusive prefix table P[k] = sum(x[:k]), k in [0, N], as (hi, lo)
    of length N+1: the sum over the inclusive range [f, l] is
    P[l+1] - P[f]."""
    hi, lo = compensated_cumsum(x)
    z = x.new_zeros((1,) + tuple(x.shape[1:]))
    return torch.cat([z, hi]), torch.cat([z, lo])


def range_sum(p_hi: torch.Tensor, p_lo: torch.Tensor, first: torch.Tensor,
              last: torch.Tensor) -> torch.Tensor:
    """Sum over the inclusive index range [first, last] from a prefix
    table, evaluated in two-float and collapsed to float32."""
    a = (p_hi[last + 1], p_lo[last + 1])
    b = (p_hi[first], p_lo[first])
    return df_to_f32(df_add(a, df_neg(b)))
