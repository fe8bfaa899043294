"""Peaks of one NVIDIA H100 SXM and the least time of the program's
hand-written kernels, for their roofline shares.

Peaks from NVIDIA's H100 SXM data sheet (dense, at the 700 W power
limit): HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 and 34 TFLOP/s in
float64 outside the tensor cores. A kernel's least time is the larger
of its bytes over the HBM rate and its operations over the peak of its
precision, with each input byte counted as read once and each output
byte as written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {4: 67e12, 8: 34e12}  # by element size in bytes


def bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    """The least time of a call that moves nbytes and computes flops in
    the precision of `itemsize`-byte floats."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[itemsize])


def k1_counts(M: int, K9: int, W: int, itemsize: int) -> tuple:
    """(bytes, flops) of one K1 call (csrc/fold.cu, outer81_fold): two
    [M, K9] strips in, [M / W, 81] out; per slot row and 9x9 block, 81
    products of K = K9 / 9 terms, a multiply and an add each."""
    R = M // W
    nbytes = (2 * M * K9 + R * 81) * itemsize
    flops = 2 * M * (K9 // 9) * 81
    return nbytes, flops


def k3_counts(N: int, iters: int) -> tuple:
    """(bytes, flops) of one K3 call (csrc/cg_dense.cu) of `iters` CG
    iterations on the real 9N rows of the reduced system, in float32:
    the system, b and the 9x9 preconditioner factors read once, x and
    the four stats written once; per iteration a GEMV, the
    preconditioner and the vector work, and one more GEMV per residual
    reset (every 10 iterations)."""
    n_rows = 9 * N
    resets = iters // 10
    flops = (iters * (2 * n_rows * n_rows + 162 * N + 14 * n_rows)
             + resets * (2 * n_rows * n_rows + n_rows))
    nbytes = (n_rows * n_rows + 9 * N + 81 * N + 9 * N + 4) * 4
    return nbytes, flops
