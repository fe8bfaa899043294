"""The port's CERES baselines (solver/numpy_lm.py, solver/scipy_baseline.py)
and their routes, on the CPU.

Both baselines are host numpy/scipy in both packages, so the port's runs
equal the JAX package's on the same problem to rel 1e-12: per-iteration
costs, flags and the final state. The numpy LM steps like the manual
solvers: its accepted costs track the port's SQUARE_ROOT solve within
5e-3 (tests/test_lm_end2end.py::test_numpy_lm_step_comparable's
criterion). `bal_ceres` runs without a card, and the CERES-only knobs
warn in the manual solvers.
"""

import copy
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from rootba_tpu.config.options import BalResidualOptions as JResidual
from rootba_tpu.config.options import RobustNorm as JNorm
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.solver.lm import bundle_adjust as j_bundle_adjust
from rootba_tpu_torch.config.options import BalResidualOptions, RobustNorm
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.config.options import SolverType
from rootba_tpu_torch.solver.lm import bundle_adjust

torch.set_num_threads(1)


def _options(pkg: str, method: str, huber: bool, **kw):
    if pkg == "jax":
        res = (JResidual(robust_norm=JNorm.HUBER, huber_parameter=0.5)
               if huber else JResidual())
        return JOptions(solver_type="CERES", baseline_method=method,
                        verbosity_level=0, residual=res, **kw)
    res = (BalResidualOptions(robust_norm=RobustNorm.HUBER,
                              huber_parameter=0.5)
           if huber else BalResidualOptions())
    return TOptions(solver_type=SolverType.CERES, baseline_method=method,
                    verbosity_level=0, residual=res, **kw)


@pytest.mark.parametrize("huber", [False, True], ids=["squared", "huber"])
@pytest.mark.parametrize("method,kw", [
    ("lm", dict(max_num_iterations=8, function_tolerance=0.0)),
    ("trf", dict(max_num_iterations=6))])
def test_baseline_equals_jax(synthetic_problem, method, kw, huber):
    """The port's baseline against the JAX package's on the same problem:
    costs, flags and the solved state to rel 1e-12."""
    pj = copy.deepcopy(synthetic_problem)
    pt = copy.deepcopy(synthetic_problem)
    j = j_bundle_adjust(pj, _options("jax", method, huber, **kw))
    t = bundle_adjust(pt, _options("port", method, huber, **kw),
                      device="cpu")
    assert len(t.iterations) == len(j.iterations) >= 4
    for a, b in zip(t.iterations, j.iterations):
        assert a.step_is_successful == b.step_is_successful
        assert a.cost.all.num_obs == b.cost.all.num_obs
        np.testing.assert_allclose(a.cost.all.error, b.cost.all.error,
                                   rtol=1e-12)
        np.testing.assert_allclose(a.cost.valid.error, b.cost.valid.error,
                                   rtol=1e-12)
    assert t.termination_type == j.termination_type
    assert t.message == j.message
    for name in ("cam_q", "cam_t", "cam_intr", "lm_p"):
        np.testing.assert_allclose(getattr(pt, name), getattr(pj, name),
                                   rtol=1e-12, atol=1e-12)
    assert t.final_cost.all.error < t.initial_cost.all.error


@pytest.mark.parametrize("huber", [False, True], ids=["squared", "huber"])
def test_numpy_lm_step_comparable_to_port(synthetic_problem, huber):
    """The numpy LM's accepted-cost trajectory tracks the port's
    SQUARE_ROOT solve on the CPU (eta 1e-5, no function tolerance)."""
    res = (BalResidualOptions(robust_norm=RobustNorm.HUBER,
                              huber_parameter=0.5)
           if huber else BalResidualOptions())
    iters = 6 if huber else 10
    s1 = bundle_adjust(copy.deepcopy(synthetic_problem), TOptions(
        max_num_iterations=iters, verbosity_level=0, bucket_pow2_from=4,
        function_tolerance=0.0, eta=1e-5, residual=res), device="cpu")
    s2 = bundle_adjust(copy.deepcopy(synthetic_problem), TOptions(
        solver_type=SolverType.CERES, baseline_method="lm",
        max_num_iterations=iters, verbosity_level=0,
        function_tolerance=0.0, eta=1e-5, residual=copy.deepcopy(res)),
        device="cpu")
    c1 = [it.cost.all.error for it in s1.iterations
          if it.step_is_successful]
    c2 = [it.cost.all.error for it in s2.iterations
          if it.step_is_successful]
    assert len(c2) >= 5
    for a, b in zip(c1, c2):
        assert abs(a - b) / max(a, 1.0) < 5e-3, (c1, c2)


@pytest.mark.parametrize("method,name", [("lm", "bal_numpy_lm"),
                                         ("trf", "bal_scipy")])
def test_bal_ceres_needs_no_card(tmp_path, method, name):
    """`bal_ceres` without --device solves on the host and writes its
    log, where the other solvers would ask for the card."""
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )
    from rootba_tpu_torch.cli import bal_ceres

    write_bal_file(generate_synthetic_bal(num_cams=8, num_lms=120, seed=11),
                   str(tmp_path / "p.txt"))
    argv = ["bal_ceres", "-C", str(tmp_path), "--input", "p.txt",
            "--quiet", "--max-num-iterations", "4",
            "--baseline-method", method, "--verbosity-level", "0"]
    cwd, saved = os.getcwd(), sys.argv
    sys.argv = argv
    try:
        assert bal_ceres.main() == 0
    finally:
        sys.argv = saved
        os.chdir(cwd)
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert log["_static"]["solver"]["solver_type"] == name
    assert log["cost"][-1] < log["cost"][0]


def test_ceres_knobs_and_checks(synthetic_problem):
    """min/max_lm_diagonal warn in the manual solvers (CERES only);
    baseline_method is checked; CERES is no linearizer."""
    from rootba_tpu_torch.bal.bucketing import bucketize
    from rootba_tpu_torch.solver.lm import create_linearizer

    with pytest.warns(UserWarning, match="min_lm_diagonal"):
        bundle_adjust(copy.deepcopy(synthetic_problem), TOptions(
            verbosity_level=0, max_num_iterations=1, min_lm_diagonal=1e-3),
            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bundle_adjust(copy.deepcopy(synthetic_problem), TOptions(
            solver_type=SolverType.CERES, baseline_method="lm",
            verbosity_level=0, max_num_iterations=1, min_lm_diagonal=1e-3),
            device="cpu")
    with pytest.raises(ValueError, match="baseline_method"):
        TOptions(baseline_method="ceres")
    with pytest.raises(ValueError, match="unknown solver type"):
        create_linearizer(bucketize(synthetic_problem),
                          TOptions(solver_type=SolverType.CERES),
                          torch.float64, torch.device("cpu"))
