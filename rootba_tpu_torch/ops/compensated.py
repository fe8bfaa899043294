"""Compensated float32 accumulation (error-free transforms).

Port of the JAX package's `ops/compensated.py`. In float32 two sums can
distort the LM trust-region logic: the CG dot products (reference
cg/conjugate_gradient.hpp:113-295) and the model cost decrease l_diff
(landmark_block_base.ipp:213-284), whose terms cancel near convergence.
These helpers carry a (hi, lo) double-float pair through a tree sum
(Knuth TwoSum, Dekker TwoProduct), accurate to ~2^-48 relative.

Every step is its own elementwise op, so no fused multiply-add can
contract the error terms away (each PyTorch op is a separate kernel).
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Error-free sum: a + b = s + err exactly (Knuth TwoSum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Dekker split into non-overlapping hi/lo halves (2^12+1 for f32,
    2^27+1 for f64)."""
    factor = 4097.0 if a.dtype == torch.float32 else 134217729.0
    c = factor * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + err exactly (Dekker TwoProduct)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _df_reduce(hi, lo):
    """Tree-reduce (hi, lo) arrays to one double-float pair in log2(n)
    vectorized two_sum levels (padded once to a power of two)."""
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    n = hi.shape[0]
    n2 = 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1
    if n2 != n:
        hi = torch.cat([hi, hi.new_zeros(n2 - n)])
        lo = torch.cat([lo, lo.new_zeros(n2 - n)])
    while hi.shape[0] > 1:
        m = hi.shape[0] // 2
        s, e = two_sum(hi[:m], hi[m:])
        lo = lo[:m] + lo[m:] + e
        hi = s
    return hi[0], lo[0]


def comp_sum2(x):
    """Compensated sum as the double-float pair (hi, lo) with
    x.sum() = hi + lo to ~2^-48 relative accuracy."""
    return _df_reduce(x, torch.zeros_like(x))


def comp_sum(x):
    """Compensated sum collapsed back to the input dtype."""
    hi, lo = comp_sum2(x)
    return hi + lo


def comp_dot(a, b):
    """Compensated dot product, returned in the input dtype."""
    p, e = two_prod(a.reshape(-1), b.reshape(-1))
    hi, lo = _df_reduce(p, e)
    return hi + lo
