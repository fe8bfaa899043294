"""Checkpoint/resume of the port's host LM driver against the JAX
package's, on the conftest problem on the CPU.

(a) The port's resumed run (a run of `split` iterations writing a
    checkpoint every iteration, then a run resumed from it) equals the
    port's straight run bit for bit: costs, radii, flags, CG counts and
    the final state.
(b) A checkpoint written by the JAX package's optimize_lm (host loop,
    num_devices=1, so rows padded to 8 as in the port's bucketize)
    resumes in the port, and one written by the port resumes in the JAX
    package. Both resumed runs match the JAX straight run: flags and CG
    counts equal, costs and the final state within rel 1e-8 in float64
    and the float32 tolerances of tests/test_torch_host_lm.py (costs
    1e-4) and tests/test_solver_equivalence.py (solved components
    2e-3). The iterations before the split come from the file, so they
    equal the writer's exactly.
(c) The file's content round-trips in both packages' readers, a
    missing file reads as None, and the attempt loop writes none.

The JAX references are made once per precision in a module-scoped
fixture on one JAX linearizer (one compile of its stages).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from rootba_tpu.bal.bucketing import bucketize as j_bucketize
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal.bucketing import bucketize as t_bucketize
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.solver import lm as tlm
from rootba_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

CPU = torch.device("cpu")
# (iterations in all, iteration of the checkpoint) per precision: float32
# stops after 3 iterations, where its costs still sit above rounding
# level (tests/test_torch_host_lm.py)
DEPTH = {"float32": (3, 1), "float64": (5, 2)}


def _base(name: str, **kw) -> dict:
    return dict(dict(verbosity_level=0, lm_loop="host",
                     function_tolerance=0.0, use_double=name == "float64",
                     max_num_iterations=DEPTH[name][0]), **kw)


def _jopts(name: str, **kw):
    return JOptions(**_base(name, **kw), num_devices=1,
                    timing_calibration_interval=0)


def _port(problem, name: str, **kw):
    """The port's host loop on the CPU: (state, summary)."""
    bp = t_bucketize(copy.deepcopy(problem))
    return tlm.optimize_lm(bp, TOptions(**_base(name, **kw)), device=CPU)


def _numpy_state(state):
    def host(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x)

    return ([host(state.cams.q), host(state.cams.t), host(state.cams.intr)]
            + [host(p) for p in state.lm_ps])


def _ri(x):
    """A ResidualInfoHost of either package as a plain dict."""
    return dataclasses.asdict(x)


def _same_flags(a, b):
    assert len(a.iterations) == len(b.iterations)
    for x, y in zip(a.iterations, b.iterations):
        assert x.iteration == y.iteration
        assert x.step_is_successful == y.step_is_successful
        assert x.step_is_valid == y.step_is_valid
        assert x.linear_solver_iterations == y.linear_solver_iterations


def _close_run(a, b, name: str):
    """a's trajectory and final state against b's at the precision's
    tolerances."""
    _same_flags(a[1], b[1])
    cost_tol, state_tol = (1e-8, 1e-8) if name == "float64" else (1e-4,
                                                                  2e-3)
    for x, y in zip(a[1].iterations, b[1].iterations):
        np.testing.assert_allclose(x.cost.all.error, y.cost.all.error,
                                   rtol=cost_tol)
        np.testing.assert_allclose(x.trust_region_radius,
                                   y.trust_region_radius, rtol=cost_tol)
    for x, y in zip(_numpy_state(a[0]), _numpy_state(b[0])):
        assert x.shape == y.shape and x.dtype == y.dtype
        scale = max(float(np.max(np.abs(y))), 1e-30)
        assert float(np.max(np.abs(x.astype(np.float64) - y))) <= (
            state_tol * scale)


@pytest.fixture(scope="module", params=["float32", "float64"])
def jax_ref(request, synthetic_problem, tmp_path_factory):
    """The JAX straight run, its checkpoint at the split and its
    linearizer (reused for the resume of the port's checkpoint)."""
    name = request.param
    d = tmp_path_factory.mktemp(f"ckpt_{name}")
    jbp = j_bucketize(copy.deepcopy(synthetic_problem), pow2_from=9)
    jlin = j_create(jbp, _jopts(name),
                    np.float64 if name == "float64" else np.float32)
    straight = j_optimize_lm(jbp, _jopts(name), linearizer=jlin)
    path = str(d / "jax.npz")
    first = j_optimize_lm(
        jbp, _jopts(name, max_num_iterations=DEPTH[name][1],
                    checkpoint_path=path, checkpoint_interval=1),
        linearizer=jlin)
    return dict(name=name, dir=d, jbp=jbp, jlin=jlin, straight=straight,
                first=first, path=path)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_port_resume_equals_port_straight(synthetic_problem, tmp_path,
                                          name):
    path = str(tmp_path / "port.npz")
    straight = _port(synthetic_problem, name)
    split = DEPTH[name][1]
    _port(synthetic_problem, name, max_num_iterations=split,
          checkpoint_path=path, checkpoint_interval=1)
    resumed = _port(synthetic_problem, name, checkpoint_path=path)
    _same_flags(resumed[1], straight[1])
    for a, b in zip(resumed[1].iterations, straight[1].iterations):
        assert a.cost.all.error == b.cost.all.error
        assert a.cost.valid.error == b.cost.valid.error
        assert a.trust_region_radius == b.trust_region_radius
        assert a.relative_decrease == b.relative_decrease
    for a, b in zip(_numpy_state(resumed[0]), _numpy_state(straight[0])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert resumed[1].termination_type == straight[1].termination_type


def test_jax_checkpoint_resumes_in_port(jax_ref, synthetic_problem):
    name = jax_ref["name"]
    resumed = _port(synthetic_problem, name, checkpoint_path=jax_ref["path"])
    _close_run(resumed, jax_ref["straight"], name)
    # the iterations up to the split are the JAX run's, from the file
    split = DEPTH[name][1]
    for a, b in zip(resumed[1].iterations[:split + 1],
                    jax_ref["first"][1].iterations):
        assert _ri(a.cost) == _ri(b.cost)
        assert _ri(a.cost_change) == _ri(b.cost_change)
        assert a.trust_region_radius == b.trust_region_radius


def test_port_checkpoint_resumes_in_jax(jax_ref, synthetic_problem):
    name = jax_ref["name"]
    path = str(jax_ref["dir"] / "port.npz")
    first = _port(synthetic_problem, name,
                  max_num_iterations=DEPTH[name][1], checkpoint_path=path,
                  checkpoint_interval=1)
    resumed = j_optimize_lm(jax_ref["jbp"], _jopts(name,
                                                   checkpoint_path=path),
                            linearizer=jax_ref["jlin"])
    _close_run(resumed, jax_ref["straight"], name)
    for a, b in zip(resumed[1].iterations, first[1].iterations):
        assert _ri(a.cost) == _ri(b.cost)
        assert _ri(a.cost_change) == _ri(b.cost_change)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_checkpoint_content_round_trips(tmp_path, dtype):
    """The port's file reads back exactly in both packages' readers, and
    the port reads the JAX package's file exactly, dtype included."""
    import jax.numpy as jnp

    from rootba_tpu.solver.lm import BAState as JState
    from rootba_tpu.solver.linearization import CamState as JCams
    from rootba_tpu.utils import checkpoint as jck
    from rootba_tpu_torch.log.summary import (
        IterationSummary,
        ResidualInfoHost,
        ResidualItemHost,
    )
    from rootba_tpu_torch.solver.linearization import CamState

    g = torch.Generator().manual_seed(5)
    state = tlm.BAState(
        cams=CamState(q=torch.randn(4, 4, generator=g, dtype=dtype),
                      t=torch.randn(4, 3, generator=g, dtype=dtype),
                      intr=torch.randn(4, 3, generator=g, dtype=dtype)),
        lm_ps=(torch.randn(8, 3, generator=g, dtype=dtype),
               torch.randn(16, 3, generator=g, dtype=dtype)))
    item = ResidualItemHost(num_obs=7, error=1.25, residual_sum=0.5)
    its = [IterationSummary(iteration=0, cost=ResidualInfoHost(
        all=item, valid=item), trust_region_radius=1e4,
        relative_decrease=float("inf"))]
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(path, state, 1e-4 / 3, 4.0, 3,
                        [tck.iteration_to_dict(i) for i in its])
    want = _numpy_state(state)
    for reader in (tck.load_checkpoint, jck.load_checkpoint):
        q, t, intr, lm_ps, lam, vee, it, dicts = reader(path)
        got = [q, t, intr, *lm_ps]
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want))
        assert (lam, vee, it) == (1e-4 / 3, 4.0, 3)
        assert [tck.iteration_from_dict(d) for d in dicts] == its

    jstate = JState(cams=JCams(*(jnp.asarray(x) for x in want[:3])),
                    lm_ps=tuple(jnp.asarray(x) for x in want[3:]))
    jpath = str(tmp_path / "j.npz")
    jck.save_checkpoint(jpath, jstate, 0.5, 2.0, 1,
                        [jck.iteration_to_dict(i) for i in its])
    q, t, intr, lm_ps, lam, vee, it, dicts = tck.load_checkpoint(jpath)
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip([q, t, intr, *lm_ps], want))
    assert (lam, vee, it) == (0.5, 2.0, 1)
    assert [tck.iteration_from_dict(d) for d in dicts] == its


def test_missing_checkpoint_and_attempt_loop(synthetic_problem, tmp_path):
    """A missing file reads as None and the host loop then starts from
    the problem (interval 0 writes nothing); the attempt loop neither
    resumes nor writes, as in the JAX package."""
    path = str(tmp_path / "none.npz")
    assert tck.load_checkpoint(path) is None
    plain = _port(synthetic_problem, "float64", max_num_iterations=2)
    again = _port(synthetic_problem, "float64", max_num_iterations=2,
                  checkpoint_path=path)
    assert ([i.cost.all.error for i in plain[1].iterations]
            == [i.cost.all.error for i in again[1].iterations])
    tlm.bundle_adjust(copy.deepcopy(synthetic_problem), TOptions(
        **dict(_base("float64"), lm_loop="fused", max_num_iterations=2,
               checkpoint_path=path, checkpoint_interval=1)), device="cpu")
    assert tck.load_checkpoint(path) is None
