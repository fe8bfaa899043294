"""The port's vectorized perturbation (BalProblem.perturb through
rng.perturbation_normals) against the per-camera, per-landmark loop it
replaced: the JAX package's BalProblem.perturb and the port's own plain
twin (rng.perturbation), bit for bit; the libstdc++ probe values; the
candidate pool's growth; and the two counters."""

import math

import numpy as np
import pytest

from rootba_tpu.bal.problem import BalProblem as JaxBalProblem
from rootba_tpu_torch.bal import nplie
from rootba_tpu_torch.bal.problem import BalProblem
from rootba_tpu_torch.bal.rng import (
    _BLOCK,
    MinstdRand0,
    _minstd_outputs,
    perturbation,
    perturbation_normals,
)
from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal
from rootba_tpu_torch.log import trace
from tests.test_rng import EXPECTED_12345, EXPECTED_38401

SEEDS = [38401, 12345, 0, 1, 2147483647, 2**31 + 5]
# (rotation, translation, point), each sigma zero in turn
SIGMAS = [(0.0, 0.01, 0.01), (0.001, 0.05, 0.05), (0.01, 0.0, 0.01),
          (0.01, 0.01, 0.0), (0.0, 0.0, 0.01), (0.01, 0.0, 0.0),
          (0.0, 0.0, 0.0)]


class _CountingEngine(MinstdRand0):
    """A MinstdRand0 that counts its outputs."""

    def __init__(self, seed: int):
        super().__init__(seed)
        self.outputs = 0

    def __call__(self) -> int:
        self.outputs += 1
        return super().__call__()


@pytest.fixture(scope="module")
def problem():
    p = generate_synthetic_bal(num_cams=23, num_lms=1500,
                               mean_obs_per_lm=3.0, seed=5)
    p.quiet = True
    p.normalize(100.0)
    return p


def _twin_perturb(p: BalProblem, rotation_sigma, translation_sigma,
                  point_sigma, eng):
    """The loop over cameras and landmarks, one rng.perturbation call
    each, in the reference's order."""
    for i in range(p.num_cameras):
        if translation_sigma > 0:
            qinv = nplie.quat_conj(p.cam_q[i])
            center = nplie.quat_rotate(qinv, -p.cam_t[i])
            center = center + perturbation(translation_sigma, eng)
            p.cam_t[i] = -nplie.quat_rotate(p.cam_q[i], center)
        if rotation_sigma > 0:
            dq = nplie.so3_exp(perturbation(rotation_sigma, eng))
            p.cam_q[i] = nplie.quat_normalize(nplie.quat_mul(dq, p.cam_q[i]))
    if point_sigma > 0:
        for i in range(p.num_landmarks):
            p.lm_p[i] += perturbation(point_sigma, eng)


def _state(p):
    return p.cam_q, p.cam_t, p.lm_p


@pytest.mark.parametrize("sigmas", SIGMAS, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_equals_the_loop_bit_for_bit(problem, seed, sigmas):
    new = problem.copy()
    new.perturb(*sigmas, seed)
    jax_p = JaxBalProblem(*(a.copy() for a in (
        problem.cam_q, problem.cam_t, problem.cam_intr, problem.lm_p,
        problem.obs_lm, problem.obs_cam, problem.obs_uv)), quiet=True)
    jax_p.perturb(*sigmas, seed)
    twin = problem.copy()
    if any(sigmas):
        _twin_perturb(twin, *sigmas, MinstdRand0(seed))
    for a, b, c, d in zip(_state(new), _state(jax_p), _state(twin),
                          _state(problem)):
        assert np.array_equal(a, b) and np.array_equal(a, c)
        assert a.dtype == d.dtype and a.shape == d.shape
    assert np.array_equal(new.cam_intr, problem.cam_intr)
    moved = [not np.array_equal(a, b)
             for a, b in zip(_state(new), _state(problem))]
    assert moved == [s > 0 for s in sigmas]


@pytest.mark.parametrize("seed,want", [(38401, EXPECTED_38401),
                                       (12345, EXPECTED_12345[:3])])
def test_first_normals_are_the_libstdcxx_probe(seed, want):
    normals, _ = perturbation_normals(MinstdRand0(seed), len(want) // 3)
    assert normals.ravel().tolist() == want


@pytest.mark.parametrize("n", [1, _BLOCK - 1, _BLOCK, _BLOCK + 1,
                               3 * _BLOCK + 5])
def test_jump_ahead_is_the_engine(n):
    eng = MinstdRand0(38401)
    want = [eng() for _ in range(n)]
    assert _minstd_outputs(38401, n).tolist() == want


@pytest.mark.parametrize("pool", [1, 2, 7, 60, None])
def test_pool_growth_gives_the_same_bits(pool):
    """A first pool too small (or the default) draws more pools: the
    normals, the candidate count and the engine's end state are the
    loop's. 1,100 calls take about 11,200 engine outputs, several rows
    of the jump-ahead."""
    n = 1100
    twin_eng = _CountingEngine(38401)
    want = np.stack([perturbation(1.0, twin_eng) for _ in range(n)])
    eng = MinstdRand0(38401)
    normals, drawn = perturbation_normals(eng, n, _pool=pool)
    assert np.array_equal(normals, want)
    assert drawn == twin_eng.outputs // 4 and twin_eng.outputs % 4 == 0
    assert eng.x == twin_eng.x


def test_no_calls_draw_nothing():
    eng = MinstdRand0(38401)
    normals, drawn = perturbation_normals(eng, 0)
    assert normals.shape == (0, 3) and drawn == 0
    assert eng.x == 38401


def test_negative_seed_draws_from_the_os(problem):
    p = problem.copy()
    p.perturb(0.0, 0.01, 0.01, -1)
    assert not np.array_equal(p.lm_p, problem.lm_p)
    assert np.all(np.isfinite(p.lm_p)) and np.all(np.isfinite(p.cam_t))
    # the point draws are N(0, 0.01^2) each
    assert np.abs(p.lm_p - problem.lm_p).max() < 0.1


def test_counters_read_calls_and_candidates(problem):
    sigmas = (0.001, 0.05, 0.05)
    p = problem.copy()
    p.perturb(*sigmas, 38401)
    assert trace.stop() == ([], {})

    eng = _CountingEngine(38401)
    _twin_perturb(problem.copy(), *sigmas, eng)
    calls = 2 * problem.num_cameras + problem.num_landmarks
    trace.start()
    problem.copy().perturb(*sigmas, 38401)
    spans, counters = trace.stop()
    assert spans == []
    assert counters == {"load.perturb_calls": calls,
                        "load.perturb_candidates": eng.outputs // 4}
    # the polar method's acceptance is pi/4
    share = 2 * calls / counters["load.perturb_candidates"]
    assert abs(share - math.pi / 4) < 0.05
