"""Kernel counts and peaks on hand-sized calls."""

import pytest

from portbench import roofline


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.FLOPS_PER_S == {4: 67e12, 8: 34e12}


def test_k1_counts_by_hand():
    # 8 slot rows, K = 2 blocks (K9 = 18), runs of 4: 2 output rows
    nbytes, flops = roofline.k1_counts(8, 18, 4, 4)
    assert nbytes == (2 * 8 * 18 + 2 * 81) * 4
    assert flops == 2 * 8 * 2 * 81
    assert roofline.k1_counts(8, 18, 4, 8)[0] == 2 * nbytes


def test_k3_counts_by_hand():
    # N = 2 cameras, 18 rows, 12 CG iterations: one residual reset
    nbytes, flops = roofline.k3_counts(2, 12)
    assert nbytes == (18 * 18 + 18 + 162 + 18 + 4) * 4
    assert flops == 12 * (2 * 324 + 324 + 252) + (2 * 324 + 18)


def test_bound_takes_the_larger_side_in_its_precision():
    assert roofline.bound_s(3.35e12, 1.0, 4) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12, 4) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 34e12, 8) == pytest.approx(1.0)
