"""Bit-exact re-implementation of the perturbation RNG of the reference.

The reference perturbs the loaded problem state with
``std::default_random_engine`` (libstdc++: minstd_rand0) +
``std::normal_distribution<double>`` (libstdc++: Marsaglia polar method
over two-draw generate_canonical), seeded with the benchmark seed 38401
(reference bal_problem.cpp:90-115, :509-554). Reproducing the exact draw
sequence lets us start from the *identical* perturbed state as the CVPR
benchmark protocol, so converged costs are directly comparable.

Verified bit-exact against a g++/libstdc++ probe in
tests/test_rng.py::test_against_cpp_probe.

`perturbation_normals` draws the normals of many successive
`perturbation` calls at once (the engine stream by jump-ahead, the polar
method's candidates as arrays) with the same bits; the engine, the
distribution and `perturbation` below are its plain twin
(tests/test_torch_perturb.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

_M = 2147483647  # 2^31 - 1
_A = 16807
# generate_canonical's range r = max - min + 1 and its divisor r * r
_R = float(_M - 1)
_R2 = _R * _R
# engine outputs per row of the jump-ahead
_BLOCK = 4096


class MinstdRand0:
    """libstdc++ std::default_random_engine = minstd_rand0."""

    def __init__(self, seed: int):
        seed = seed % _M
        if seed == 0:
            seed = 1
        self.x = seed

    def __call__(self) -> int:
        self.x = (self.x * _A) % _M
        return self.x

    min = 1
    max = _M - 1  # 2147483646


class NormalDistribution:
    """libstdc++ std::normal_distribution<double> (Marsaglia polar).

    Each fresh distribution object starts with an empty cache; the
    reference constructs a fresh one per perturbation<N>() call.
    """

    def __init__(self):
        self.saved = None

    def _canonical(self, eng: MinstdRand0) -> float:
        # std::generate_canonical<double, 53>(minstd_rand0):
        # r = max-min+1 = 2147483646, log2(r) ~ 31, k = ceil(53/31) = 2
        r = float(eng.max - eng.min + 1)
        sum_ = float(eng() - eng.min)
        tmp = r
        sum_ += float(eng() - eng.min) * tmp
        tmp *= r
        ret = sum_ / tmp
        if ret >= 1.0:
            ret = math.nextafter(1.0, 0.0)
        return ret

    def __call__(self, eng: MinstdRand0) -> float:
        if self.saved is not None:
            v = self.saved
            self.saved = None
            return v
        while True:
            x = 2.0 * self._canonical(eng) - 1.0
            y = 2.0 * self._canonical(eng) - 1.0
            r2 = x * x + y * y
            if r2 <= 1.0 and r2 != 0.0:
                break
        mult = math.sqrt(-2.0 * math.log(r2) / r2)
        self.saved = x * mult
        return y * mult


def perturbation(sigma: float, eng: MinstdRand0, n: int = 3) -> np.ndarray:
    """Reference bal_problem.cpp perturbation<T,N>: fresh distribution,
    n draws scaled by sigma."""
    dist = NormalDistribution()
    return np.array([dist(eng) * sigma for _ in range(n)], dtype=np.float64)


def _powers(g: int, n: int) -> np.ndarray:
    """g^1..g^n mod M by doubling (g^(k+m) = g^k g^m). Every product is
    of two values below 2^31, exact in int64."""
    powers = np.array([g], dtype=np.int64)
    while powers.size < n:
        powers = np.concatenate(
            [powers, powers[:n - powers.size] * powers[-1] % _M])
    return powers[:n]


def _minstd_outputs(x: int, n: int) -> np.ndarray:
    """The next n outputs of a MinstdRand0 in state x, x A^k mod M for
    k = 1..n, by jump-ahead: rows of B = _BLOCK outputs, each row's
    start x A^(jB) times A^1..A^B."""
    step = _powers(_A, _BLOCK)
    rows = -(-n // _BLOCK)
    starts = np.concatenate([[x], x * _powers(int(step[-1]), rows - 1) % _M])
    return (starts[:, None] * step % _M).ravel()[:n]


def _polar_candidates(eng: MinstdRand0, n: int):
    """n polar-method candidates from eng, 4 engine outputs each (two
    two-output generate_canonical calls), as NormalDistribution draws
    them: (x, y, r2, outputs)."""
    out = _minstd_outputs(eng.x, 4 * n)
    u = (out - 1).astype(np.float64).reshape(n, 2, 2)
    c = (u[:, :, 0] + u[:, :, 1] * _R) / _R2
    c = np.where(c >= 1.0, math.nextafter(1.0, 0.0), c)
    x = 2.0 * c[:, 0] - 1.0
    y = 2.0 * c[:, 1] - 1.0
    return x, y, x * x + y * y, out


def perturbation_normals(eng: MinstdRand0, n: int,
                         _pool: Optional[int] = None
                         ) -> Tuple[np.ndarray, int]:
    """The draws of n successive `perturbation(1.0, eng, 3)` calls, bit
    for bit, as an [n, 3] array; eng ends where those calls leave it.
    Returns (normals, polar candidates drawn).

    Each call takes two accepted candidates (r2 <= 1, r2 != 0) from a
    fresh distribution: (y1 m1, x1 m1, y2 m2), the second x2 m2 thrown
    away, with m = sqrt(-2 log(r2) / r2). The log is libm's through
    math.log, as the twin takes it (numpy's vectorized log differs in
    the last bit); sqrt and the arithmetic are correctly rounded either
    way. Candidates come in pools of the expected need (acceptance
    pi/4) plus a margin, a further pool where one falls short; `_pool`
    sets the first pool's size, for the tests."""
    if n == 0:
        return np.zeros((0, 3)), 0
    need = 2 * n
    if _pool is None:
        _pool = int(need * 4 / math.pi + 6 * math.sqrt(need)) + 16
    xs, ys, r2s = [], [], []
    got = drawn = 0
    while True:
        x, y, r2, out = _polar_candidates(eng, _pool)
        ok = np.flatnonzero((r2 <= 1.0) & (r2 != 0.0))[:need - got]
        xs.append(x[ok])
        ys.append(y[ok])
        r2s.append(r2[ok])
        got += ok.size
        if got == need:
            break
        drawn += _pool
        eng.x = int(out[-1])
        _pool = int((need - got) * 4 / math.pi
                    + 6 * math.sqrt(need - got)) + 16
    drawn += int(ok[-1]) + 1
    eng.x = int(out[4 * ok[-1] + 3])
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    r2 = np.concatenate(r2s)
    log = np.fromiter(map(math.log, r2.tolist()), np.float64, r2.size)
    m = np.sqrt(-2.0 * log / r2)
    a = (y * m).reshape(n, 2)
    b = (x * m).reshape(n, 2)
    return np.stack([a[:, 0], b[:, 0], a[:, 1]], axis=1), drawn
