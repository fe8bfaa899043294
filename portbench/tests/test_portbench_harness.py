"""The harness driven on the CPU, without the card's check: a tiny cell
from new files, its result line, the faults that must read as not
correct, the refusal without a card or without the program, and the
check for JAX in the process."""

import json
import os
import subprocess
import sys
import types

import pytest

from conftest import ROOT, add_tiny_cell
from portbench import run

F32_LIMITS = json.loads((ROOT / "portbench/limits/traf257.sqrt-f32.json")
                        .read_text())


def drive(root, cell, capsys, trace=0, seconds="0.1"):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                   "--seconds", seconds, "--trace", str(trace)],
                  device="cpu", root=root)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 else out)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_and_is_correct(bench_copy, capsys, trace):
    cell = add_tiny_cell(bench_copy, "sqrt-f32-20it", F32_LIMITS)
    rc, res = drive(bench_copy, cell, capsys, trace)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(F32_LIMITS)
    want = ({"solve_s", "setup_s"} if not trace else
            {"load_s", "host_prep_s", "lm_iter_ms", "stage1_ms",
             "stage2_ms", "lsolve_ms", "lsolve_iters"})
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert not list(bench_copy.parent.glob("portbench-*.txt"))


def _state_unchanged(monkeypatch):
    from rootba_tpu_torch.solver.sqrt_flat import FlatSqrtLinearizer

    inner = FlatSqrtLinearizer.apply

    def apply(self, cams, lm_ps, *args):
        _, _, l_diff = inner(self, cams, lm_ps, *args)
        return cams, lm_ps, l_diff

    monkeypatch.setattr(FlatSqrtLinearizer, "apply", apply)


def _half_left_out(monkeypatch):
    from rootba_tpu_torch.bal import problem as mod

    inner = mod.load_normalized_bal_problem

    def load(options, *a, **k):
        p = inner(options, *a, **k)
        keep = p.obs_lm % 2 == 0  # every other landmark, renumbered
        p.obs_lm, p.obs_cam, p.obs_uv = (p.obs_lm[keep] // 2,
                                         p.obs_cam[keep], p.obs_uv[keep])
        p.lm_p = p.lm_p[::2].copy()
        return p

    monkeypatch.setattr(mod, "load_normalized_bal_problem", load)


def _answer_altered(monkeypatch):
    from rootba_tpu_torch.solver import lm as mod

    inner = mod.bundle_adjust

    def bundle_adjust(problem, *a, **k):
        s = inner(problem, *a, **k)
        problem.lm_p[0] += 1.0
        return s

    monkeypatch.setattr(mod, "bundle_adjust", bundle_adjust)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_faults_read_not_correct(bench_copy, capsys, monkeypatch, fault):
    cell = add_tiny_cell(bench_copy, "sqrt-f32-20it", F32_LIMITS)
    fault(monkeypatch)
    rc, res = drive(bench_copy, cell, capsys)
    assert rc == 0 and not res["correct"] and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_jax_in_the_process_fails_the_run(bench_copy, capsys, monkeypatch):
    cell = add_tiny_cell(bench_copy, "sqrt-f32-20it", F32_LIMITS)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out = drive(bench_copy, cell, capsys)
    assert rc != 0 and not any(line.startswith("{") for line in out)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rootba_tpu_torch_extra",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rootba_tpu.solver",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib", "rootba_tpu"]


def test_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "traf257.sqrt-f32", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


def test_exits_nonzero_without_the_program(bench_copy):
    """In a checkout of BENCHMARK.json and portbench/ alone the run
    stops at the import of rootba_tpu_torch and prints no result."""
    code = ("import sys; from pathlib import Path; import portbench.run as r;"
            f" sys.exit(r.main(['--workload', 'traf257.sqrt-f32', '--seed',"
            f" '1', '--seconds', '1'], device='cpu',"
            f" root=Path({str(bench_copy)!r})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=bench_copy,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout
    assert "rootba_tpu_torch" in p.stderr


def test_trace_reduction():
    from portbench.trace import DeviceTrace

    tr = DeviceTrace(ops=[("k<float>", 1.0, 2.0), ("k<float>", 1.5, 3.0),
                          ("m", 5.0, 6.0), ("m", 9.0, 11.0)],
                     t0=0.0, t1=10.0,
                     kernels={"k": [2, 2.5], "m": [2, 3.0]})
    assert tr.busy_intervals() == [(1.0, 3.0), (5.0, 6.0), (9.0, 10.0)]
    assert tr.busy_s() == pytest.approx(4.0)
    assert tr.gaps() == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.0)]
    assert tr.top_ops(1) == [["m", 3.0]]
    assert tr.launches("k") == 2 and tr.seconds("m") == 3.0
