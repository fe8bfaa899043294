"""The port's landmark mesh (parallel/mesh.py) on torch.distributed: two
gloo processes on the CPU against one, against the unsharded port and
against the JAX package's single-device solves, on the conftest problem
(12 cameras, 200 landmarks) in float64.

Worker processes are spawned twice per module, in the pattern of
tests/test_multiprocess.py: round 1 runs a world of 1 rank and a world
of 2 ranks side by side, each solving with SQUARE_ROOT (the einsum
layout), SC (the scatter assembly) and PoBA (the implicit E0 sweep) on
the attempt loop, and writing a checkpoint from a host-loop solve of 2
LM iterations; the world of 2 then gives its ranks two checkpoint paths
of which only rank 1's exists. Round 2 resumes each world's checkpoint
in the other world (2 -> 1 and 1 -> 2) to 4 iterations. Every worker
has a timeout.

Held: each world-2 solve to the world-1 solve (the same flags and CG
counts, costs within rel 1e-10, final states within 1e-10), both ranks'
summaries identical; the world-1 mesh to the unsharded port with the
same reductions (segment sums: reduction_alg=0, dense_rcs_max_cameras
=0) bit for bit, an all-reduce over one rank being the identity; the
world-2 solves to the JAX package's single-device solves of the same
routes (rel 1e-8; tests/test_sharding.py holds those to the JAX mesh);
the resumed solves to the straight 4-iteration solve (rel 1e-8); the
disagreeing checkpoint paths raise on both ranks; pad_rows_for_mesh and
make_mesh without a process group.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rootba_tpu.bal.bucketing import bucketize as j_bucketize
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.config.options import SolverType as JSolver
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal.problem import BalProblem
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.parallel import mesh as tmesh
from rootba_tpu_torch.solver.lm import bundle_adjust

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SOLVERS = ("SQUARE_ROOT", "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT")
# the options of every solve (and the JAX references'): float64, the
# einsum / scatter / implicit routes a mesh takes
OPTS = dict(verbosity_level=0, max_num_iterations=5, use_double=True,
            kernel_layout="einsum", dense_rcs_max_cameras=0)
WORKER_TIMEOUT_S = 240

_WORKER = r"""
import json, os, sys
rank, world, port, work, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
import torch
torch.set_num_threads(1)
from rootba_tpu_torch.parallel import mesh
mesh.init_distributed(f"localhost:{port}", world, rank)
assert torch.distributed.get_backend() == "gloo"
from rootba_tpu_torch.bal.problem import BalProblem
from rootba_tpu_torch.config.options import SolverOptions, SolverType
from rootba_tpu_torch.solver.lm import bundle_adjust

OPTS = json.loads(sys.argv[6])
SOLVERS = json.loads(sys.argv[7])


def solve(solver, **kw):
    p = BalProblem.load_npz(os.path.join(work, "problem.npz"))
    mesh.reset_stats()
    s = bundle_adjust(p, SolverOptions(
        **dict(OPTS, solver_type=SolverType(solver), **kw)), device="cpu")
    its = s.iterations
    return dict(cost=[i.cost.all.error for i in its],
                ok=[i.step_is_successful for i in its],
                cg=[i.linear_solver_iterations for i in its],
                cam_t=p.cam_t.tolist(), lm_p=p.lm_p.tolist(),
                all_reduces=mesh.STATS["all_reduces"])


ck = os.path.join(work, "ckpt_w%d.npz")
out = {}
if mode == "write":
    for solver in SOLVERS:
        out[solver] = solve(solver)
    out["written"] = solve("SQUARE_ROOT", lm_loop="host",
                           max_num_iterations=2, checkpoint_interval=1,
                           checkpoint_path=ck % world)
    if world == 1:
        out["straight"] = solve("SQUARE_ROOT", lm_loop="host",
                                max_num_iterations=4)
    else:
        # a checkpoint path that only rank 1 sees
        path = ck % 2 if rank == 1 else os.path.join(work, "none.npz")
        try:
            solve("SQUARE_ROOT", lm_loop="host", checkpoint_path=path)
            out["disagree"] = None
        except FileNotFoundError as e:
            out["disagree"] = str(e)
else:
    out["resumed"] = solve("SQUARE_ROOT", lm_loop="host",
                           max_num_iterations=4,
                           checkpoint_path=ck % (3 - world))
with open(os.path.join(work, "%s_w%d_r%d.json" % (mode, world, rank)),
          "w") as fp:
    json.dump(out, fp)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_round(work: Path, mode: str) -> dict:
    """A world of 1 and a world of 2 side by side; returns
    {(world, rank): result}."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for world in (1, 2):
        port = str(_free_port())
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(work / "worker.py"), str(rank),
                 str(world), port, str(work), mode, json.dumps(OPTS),
                 json.dumps(SOLVERS)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for pr in procs:
        try:
            text, _ = pr.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pr.kill()
            text, _ = pr.communicate()
        outs.append(text.decode(errors="replace"))
    for pr, text in zip(procs, outs):
        assert pr.returncode == 0, f"worker failed:\n{text[-4000:]}"
    return {(w, r): json.loads((work / f"{mode}_w{w}_r{r}.json").read_text())
            for w in (1, 2) for r in range(w)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, synthetic_problem):
    work = tmp_path_factory.mktemp("mesh")
    synthetic_problem.save_npz(str(work / "problem.npz"))
    (work / "worker.py").write_text(_WORKER)
    return _spawn_round(work, "write"), _spawn_round(work, "resume")


def _held(got, want, rtol, what, states=True):
    assert got["ok"] == want["ok"], what
    assert got["cg"] == want["cg"], what
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=rtol,
                               err_msg=what)
    if states:
        for k in ("cam_t", "lm_p"):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=rtol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("solver", SOLVERS)
def test_world2_matches_world1(worlds, solver):
    written, _ = worlds
    r0, r1, w1 = written[2, 0], written[2, 1], written[1, 0]
    assert r0[solver] == r1[solver]  # the ranks' summaries and states
    _held(r0[solver], w1[solver], 1e-10, solver)
    assert r0[solver]["all_reduces"] == w1[solver]["all_reduces"] > 0
    assert r0[solver]["cost"][-1] < r0[solver]["cost"][0]


def _port_unsharded(problem, solver):
    p = BalProblem(*(np.array(getattr(problem, k)) for k in (
        "cam_q", "cam_t", "cam_intr", "lm_p", "obs_lm", "obs_cam",
        "obs_uv")))
    s = bundle_adjust(p, TOptions(**dict(OPTS, solver_type=solver,
                                         reduction_alg=0)), device="cpu")
    return [i.cost.all.error for i in s.iterations], p


@pytest.mark.parametrize("solver", SOLVERS)
def test_world1_mesh_equals_no_mesh(worlds, synthetic_problem, solver):
    """A mesh of one rank adds only identity all-reduces to the unsharded
    solve with the same reductions."""
    w1 = worlds[0][1, 0][solver]
    costs, p = _port_unsharded(synthetic_problem, solver)
    assert costs == w1["cost"]
    assert p.lm_p.tolist() == w1["lm_p"]


@pytest.mark.parametrize("solver", SOLVERS)
def test_world2_matches_jax(worlds, synthetic_problem, solver):
    """The JAX package on one device, the same route (einsum layout,
    scatter assembly, implicit E0 sweep), its host loop."""
    bp = j_bucketize(synthetic_problem, pow2_from=9)
    opts = JOptions(**dict(OPTS, solver_type=JSolver(solver),
                           lm_loop="host", num_devices=1,
                           host_fused_attempt=False))
    _, j = j_optimize_lm(bp, opts, linearizer=j_create(bp, opts, np.float64))
    want = dict(cost=[i.cost.all.error for i in j.iterations],
                ok=[i.step_is_successful for i in j.iterations],
                cg=[i.linear_solver_iterations for i in j.iterations])
    _held(worlds[0][2, 0][solver], want, 1e-8, solver, states=False)


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_elastic_resume(worlds, direction):
    """A checkpoint written by one world resumes in the other, with the
    straight solve's flags, CG counts and costs (rel 1e-8)."""
    written, resumed = worlds
    straight = written[1, 0]["straight"]
    world = 1 if direction == "2to1" else 2
    got = [resumed[world, r]["resumed"] for r in range(world)]
    assert all(g == got[0] for g in got)
    assert len(got[0]["cost"]) == len(straight["cost"]) == 5
    _held(got[0], straight, 1e-8, direction)
    # the writing runs stopped after 2 iterations, as the straight one
    # passed them
    for w in (1, 2):
        _held(written[w, 0]["written"], dict(
            {k: v[:3] for k, v in straight.items()
             if k in ("cost", "ok", "cg")}), 1e-8, f"written w{w}",
            states=False)


def test_checkpoint_disagreement_raises(worlds):
    """Rank 1 sees the checkpoint, rank 0 does not: both raise (none
    hangs in a collective), with the JAX package's text."""
    written, _ = worlds
    for r in (0, 1):
        msg = written[2, r]["disagree"]
        assert msg is not None and "is visible on process 0: False but " \
            "on process 1: True" in msg and "resolve identically" in msg


def test_cli_launch_from_environment(tmp_path, synthetic_problem):
    """Two `cli.bal` processes with ROOTBA_COORDINATOR /
    ROOTBA_NUM_PROCESSES / ROOTBA_PROCESS_ID join one gloo group and
    solve sharded; rank 0 alone writes ba_log.json, whose costs and CG
    counts are the unsharded CLI solve's (rel 1e-10)."""
    from rootba_tpu_torch.cli.bal import run_app

    problem = tmp_path / "problem.npz"
    synthetic_problem.save_npz(str(problem))
    argv = ["--input", str(problem), "--device", "cpu", "--use-double",
            "true", "--max-num-iterations", "4", "--kernel-layout",
            "einsum", "--quiet"]
    port = str(_free_port())
    procs = []
    for rank in range(2):
        (tmp_path / f"r{rank}").mkdir()
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   ROOTBA_COORDINATOR=f"localhost:{port}",
                   ROOTBA_NUM_PROCESSES="2", ROOTBA_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rootba_tpu_torch.cli.bal", "-C",
             str(tmp_path / f"r{rank}"), *argv], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for pr in procs:
        try:
            text, _ = pr.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pr.kill()
            text, _ = pr.communicate()
        assert pr.returncode == 0, text.decode(errors="replace")[-4000:]
    assert not (tmp_path / "r1" / "ba_log.json").exists()
    got = json.loads((tmp_path / "r0" / "ba_log.json").read_text())
    cwd = os.getcwd()
    try:
        assert run_app("test", ["-C", str(tmp_path), *argv]) == 0
    finally:
        os.chdir(cwd)
    want = json.loads((tmp_path / "ba_log.json").read_text())
    assert got["linear_solver_iterations"] == want["linear_solver_iterations"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-10)


@pytest.mark.parametrize("ndev,align", [(1, 8), (2, 8), (4, 8), (8, 8),
                                        (3, 24)])
def test_pad_rows_for_mesh(ndev, align):
    """lcm(8, ndev): the JAX package's value for powers of two; 3 (whose
    JAX loop never ends) gives 24."""
    assert tmesh.pad_rows_for_mesh(ndev) == align
    assert tmesh.pad_rows_for_mesh(ndev) % ndev == 0


def test_make_mesh_without_process_group():
    """No process group: num_devices 0 and 1 are no mesh, 2 is an
    error; shard and gather helpers are the identity."""
    assert not torch.distributed.is_initialized()
    cpu = torch.device("cpu")
    assert tmesh.make_mesh(0, cpu) is None
    assert tmesh.make_mesh(1, cpu) is None
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.make_mesh(2, cpu)
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.shard_rows(x, None) is x
    assert tmesh.all_reduce_sum(x, None) is x
    assert np.array_equal(tmesh.gather_to_host(x, None), x.numpy())
    m = tmesh.LandmarkMesh(rank=1, size=2, device=torch.device("cpu"))
    assert m.rows(8) == (4, 8)
    assert torch.equal(tmesh.shard_rows(torch.arange(8), m),
                       torch.arange(4, 8))
    with pytest.raises(ValueError, match="do not divide"):
        m.rows(7)
