"""The plain reference against the port on the CPU, on a tiny twin: the
same loaded problem, the same cost, the same LM trajectory in float64;
and the control, the reference one precision down, failing the limits
that the program passes."""

import json

import numpy as np
import pytest

from conftest import ROOT
from portbench import twin
from portbench.references import bal_lm
from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
from rootba_tpu_torch.bal.rng import MinstdRand0, perturbation
from rootba_tpu_torch.config.options import (
    BalDatasetOptions,
    SolverOptions,
    SolverType,
)
from rootba_tpu_torch.log.summary import SolverSummary
from rootba_tpu_torch.solver.lm import bundle_adjust

CONF = json.loads((ROOT / "portbench/configs/bal-trafalgar-257.json")
                  .read_text())
DATASET = dict(CONF["dataset"], quiet=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "tiny.txt"
    twin.write_bal(twin.generate(16, 300, 1500, 11, **CONF["twin"]),
                   str(path), order_seed=2 ** 31 + 9)
    return str(path)


def load_port(path):
    return load_normalized_bal_problem(BalDatasetOptions(input=path,
                                                         **DATASET))


def port_solve(path, solver_type, use_double, iters, device="cpu"):
    p = load_port(path)
    o = SolverOptions()
    o.solver_type = SolverType(solver_type)
    o.use_double = use_double
    o.max_num_iterations = iters
    o.function_tolerance = 0.0
    o.verbosity_level = 0
    s = bundle_adjust(p, o, SolverSummary(), device=device)
    return p, s


@pytest.mark.parametrize("seed", [1, 38401, 2 ** 31 + 77])
def test_perturbation_stream_is_libstdcxx(seed):
    eng = MinstdRand0(seed)
    want = np.stack([perturbation(1.0, eng) for _ in range(50)])
    assert np.array_equal(bal_lm._normal_triples(seed, 50), want)


def test_loaded_problem_equals_the_ports(tiny):
    got = bal_lm.preprocess(bal_lm.read_bal(tiny), DATASET)
    want = load_port(tiny)
    for k in ("obs_lm", "obs_cam", "obs_uv", "cam_q", "cam_t", "cam_intr",
              "lm_p"):
        assert np.array_equal(got[k], getattr(want, k)), k


@pytest.mark.parametrize("solver_type",
                         ["SQUARE_ROOT", "POWER_SCHUR_COMPLEMENT"])
def test_float64_trajectory_equals_the_ports(tiny, solver_type):
    p, s = port_solve(tiny, solver_type, True, 6)
    ref = bal_lm.solve(bal_lm.preprocess(bal_lm.read_bal(tiny), DATASET),
                       dict(solver_type=solver_type, use_double=True,
                            function_tolerance=0.0), 6, "cpu")
    want = [it.cost.all.error for it in s.iterations]
    assert len(ref["costs"]) == len(want)
    np.testing.assert_allclose(ref["costs"], want, rtol=1e-9)
    np.testing.assert_allclose(ref["state"]["lm_p"], p.lm_p, rtol=1e-7,
                               atol=1e-9)
    assert bal_lm.cost(bal_lm.preprocess(bal_lm.read_bal(tiny), DATASET),
                       dict(cam_q=p.cam_q, cam_t=p.cam_t,
                            cam_intr=p.cam_intr, lm_p=p.lm_p),
                       "cpu") == pytest.approx(s.final_cost.all.error,
                                               rel=1e-12)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("traffic,workload", [
    ("sqrt-f32-20it", "traf257.sqrt-f32"),
    ("poba-f64-10it", "final3068.poba-f64")])
def test_control_fails_where_the_program_passes(tiny, traffic, workload,
                                                device):
    """The control: the reference one precision down (TF32 products for
    float32, float32 for float64) in the program's place. On the card
    (`-m cuda`) the program and both references run there."""
    import torch

    from portbench.control import control_answer

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

    solver = json.loads((ROOT / f"portbench/traffic/{traffic}.json")
                        .read_text())["solver"]
    limits = json.loads((ROOT / f"portbench/limits/{workload}.json")
                        .read_text())
    dataset = dict(DATASET, input=tiny)
    p, s = port_solve(tiny, solver["solver_type"], solver["use_double"],
                      solver["max_num_iterations"], device)
    program = dict(obs_lm=p.obs_lm, obs_cam=p.obs_cam, obs_uv=p.obs_uv,
                   cam_q=p.cam_q, cam_t=p.cam_t, cam_intr=p.cam_intr,
                   lm_p=p.lm_p, initial_cost=s.initial_cost.all.error,
                   final_cost=s.final_cost.all.error)
    control = control_answer(bal_lm, tiny, dataset, solver, device)
    got, ctl = bal_lm.judge(tiny, dataset, solver,
                            solver["max_num_iterations"],
                            [program, control], device)
    assert all(got[k] <= lim for k, lim in limits.items()), got
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl
