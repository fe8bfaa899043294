"""The port's entry points: the CLI on the CPU, its log, its device
default, and the rule that the port imports neither jax nor the JAX
package."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rootba_tpu_torch"


def _write_problem(path):
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )

    p = generate_synthetic_bal(num_cams=8, num_lms=120, seed=11)
    write_bal_file(p, str(path))
    return path


def test_port_imports_no_jax_in_a_fresh_process(tmp_path):
    """Importing the port (its eval tools too) and solving on the CPU with
    each of its solvers (and the obs pair gather) leaves jax
    and the JAX package out of sys.modules."""
    prog = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import torch
torch.set_num_threads(1)
from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal
from rootba_tpu_torch.config.options import SolverOptions
from rootba_tpu_torch.solver.lm import bundle_adjust
import rootba_tpu_torch.cli.bal, rootba_tpu_torch.cli.bal_qr
import rootba_tpu_torch.cli.bal_sc, rootba_tpu_torch.cli.bal_power_sc
import rootba_tpu_torch.cli.bal_ceres
from rootba_tpu_torch.bal import problem, rootba_io
from rootba_tpu_torch.config.options import SolverType
from rootba_tpu_torch.native import runtime
import rootba_tpu_torch.eval.log, rootba_tpu_torch.eval.metrics
import rootba_tpu_torch.eval.run, rootba_tpu_torch.eval.experiments
import rootba_tpu_torch.eval.report, rootba_tpu_torch.eval.generate_tables
import rootba_tpu_torch.eval.plot_logs, rootba_tpu_torch.eval.num_ops
import rootba_tpu_torch.eval.html_view, rootba_tpu_torch.eval.view
import rootba_tpu_torch.eval.live_view
for solver in ("SQUARE_ROOT", "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT",
               "CERES"):
    for method in (("trf", "lm") if solver == "CERES" else ("trf",)):
        p = generate_synthetic_bal(num_cams=6, num_lms=60, seed=2)
        p.filter_obs(0.1)
        s = bundle_adjust(p, SolverOptions(
            use_double=False, verbosity_level=0, max_num_iterations=3,
            solver_type=SolverType(solver), baseline_method=method,
            lm_loop="host", checkpoint_path=f"ck_{{solver}}_{{method}}.npz",
            checkpoint_interval=1), device="cpu")
        assert s.final_cost.all.error < s.initial_cost.all.error, solver
from rootba_tpu_torch.parallel import mesh
from rootba_tpu_torch.solver import sqrt_qr
p = generate_synthetic_bal(num_cams=6, num_lms=60, seed=2)
p.filter_obs(0.1)
s = bundle_adjust(p, SolverOptions(
    use_double=False, verbosity_level=0, max_num_iterations=3,
    kernel_layout="einsum", num_devices=0), device="cpu")
assert s.final_cost.all.error < s.initial_cost.all.error, "einsum"
for solver in ("SQUARE_ROOT", "SCHUR_COMPLEMENT"):
    p = generate_synthetic_bal(num_cams=6, num_lms=60, seed=2)
    p.filter_obs(0.1)
    s = bundle_adjust(p, SolverOptions(
        use_double=False, verbosity_level=0, max_num_iterations=3,
        solver_type=SolverType(solver), pair_gather="obs"), device="cpu")
    assert s.final_cost.all.error < s.initial_cost.all.error, solver
rootba_io.save_rootba(p, "p.cereal")
rootba_io.load_rootba("p.cereal")
p.save_bal("p.txt")
assert runtime.available()
problem.load_bal("p.txt", quiet=True)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "rootba_tpu"
       or m.startswith("rootba_tpu.")]
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rootba_tpu)(\.|\s|$)",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert PORT / "parallel" / "mesh.py" in files
    assert PORT / "solver" / "sqrt_qr.py" in files
    for f in files:
        m = pat.search(f.read_text())
        assert m is None, f"{f}: {m.group(0)!r}"


def test_every_cli_script_has_a_torch_script():
    """pyproject.toml installs, for every console script of the JAX
    package's CLI, a `<name>-torch` script on the port's module of the
    same name, whose main imports and is callable."""
    import importlib
    import tomllib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    jax_scripts = {name: target for name, target in scripts.items()
                   if target.startswith("rootba_tpu.cli.")}
    assert set(jax_scripts) == {"bal", "bal-qr", "bal-sc", "bal-power-sc"}
    for name, target in jax_scripts.items():
        module = target.split(":")[0].rsplit(".", 1)[1]
        assert (scripts.get(f"{name}-torch")
                == f"rootba_tpu_torch.cli.{module}:main"), name
        main = importlib.import_module(f"rootba_tpu_torch.cli.{module}").main
        assert callable(main), name


def test_cli_cpu_writes_the_reference_log(tmp_path, capsys):
    """`--device cpu` solves and writes a ba_log.json with the fields of
    the JAX package's log, which its log reader loads."""
    from rootba_tpu.eval.log import load_ba_log
    from rootba_tpu.log.ba_log import build_log_dict as j_build
    from rootba_tpu.log.summary import SolverSummary as JSummary
    from rootba_tpu_torch.cli.bal import run_app

    bal = _write_problem(tmp_path / "problem.txt")
    cwd = os.getcwd()
    try:
        rc = run_app("test", ["-C", str(tmp_path), "--input", str(bal),
                              "--device", "cpu", "--use-double", "false",
                              "--max-num-iterations", "4",
                              "--init-depth-threshold", "0.1"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    log = json.loads((tmp_path / "ba_log.json").read_text())
    ref = j_build(JSummary())
    assert set(log) == set(ref)
    for k in ref["_static"]:
        assert set(log["_static"][k]) == set(ref["_static"][k]), k
    assert log["_static"]["solver"]["solver_type"] == "bal_qr"
    assert log["cost"][-1] < log["cost"][0]
    assert len(log["cost"]) == 5
    loaded = load_ba_log(str(tmp_path / "ba_log.json"))
    assert loaded is not None
    assert "Final Cost" in capsys.readouterr().out


def test_cli_help_and_dump_config(capsys):
    from rootba_tpu_torch.cli.bal import run_app
    from rootba_tpu_torch.cli.bal_qr import main as qr_main

    with pytest.raises(SystemExit) as e:
        run_app("test", ["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--dense-rcs-max-cameras" in out
    assert "--bsr-pack-max-gb" in out
    assert run_app("test", ["--dump-config", "--use-double", "false",
                            "--no-jacobi-scaling"]) == 0
    out = capsys.readouterr().out
    assert "use_double = false" in out and "jacobi_scaling = false" in out
    argv = sys.argv
    sys.argv = ["bal_qr", "--dump-config"]
    try:
        assert qr_main() == 0
    finally:
        sys.argv = argv
    assert 'solver_type = "SQUARE_ROOT"' in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--timing-calibration-interval", "1"],
                                  ["--host-fused-attempt", "false"],
                                  ["--defer-stage-sync", "false"],
                                  ["--pair-gather", "strips"],
                                  ["--strip-min-group", "0"],
                                  ["--strip-auto-obs-threshold", "1"]])
def test_cli_rejects_knobs_of_unported_paths(argv, capsys):
    """The port's config has no options for paths it does not have, so
    such a flag is an argparse error instead of being ignored; the JAX
    package's "strips" pair gather is not one of --pair-gather's
    choices."""
    from rootba_tpu_torch.cli.bal import run_app

    with pytest.raises(SystemExit) as e:
        run_app("test", ["--dump-config", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    if argv[0] == "--pair-gather":
        assert "invalid choice: 'strips'" in err
    else:
        assert "unrecognized arguments" in err


@pytest.mark.parametrize("where", ["options", "config_file"])
def test_strips_gather_is_rejected(where, tmp_path):
    """pair_gather="strips", from SolverOptions or from a config file,
    raises the ValueError that names the two gathers (a config file's
    value no longer reaches the solver unchecked)."""
    from rootba_tpu_torch.cli.bal import run_app
    from rootba_tpu_torch.config.options import SolverOptions

    allowed = r"is not one of \('stream', 'obs'\)"
    if where == "options":
        with pytest.raises(ValueError,
                           match="pair_gather=.strips. " + allowed):
            SolverOptions(pair_gather="strips")
        return
    (tmp_path / "rootba_config.toml").write_text(
        '[solver]\npair_gather = "strips"\n')
    cwd = os.getcwd()
    try:
        with pytest.raises(ValueError,
                           match="solver.pair_gather=.strips. " + allowed):
            run_app("test", ["-C", str(tmp_path), "--dump-config"])
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("ndev", [1, 2])
def test_cli_num_devices(ndev, tmp_path, capsys):
    """--num-devices is an option again: 1 dumps and solves unsharded;
    2 without a process group raises the mesh's ValueError before any
    solve."""
    from rootba_tpu_torch.cli.bal import run_app

    assert run_app("test", ["--dump-config", "--num-devices",
                            str(ndev)]) == 0
    assert f"num_devices = {ndev}" in capsys.readouterr().out
    bal = _write_problem(tmp_path / "problem.txt")
    argv = ["-C", str(tmp_path), "--input", str(bal), "--device", "cpu",
            "--max-num-iterations", "2", "--num-devices", str(ndev)]
    cwd = os.getcwd()
    try:
        if ndev == 1:
            assert run_app("test", argv) == 0
        else:
            with pytest.raises(ValueError, match="num_devices=2 needs a "
                                                 "process group"):
                run_app("test", argv)
    finally:
        os.chdir(cwd)
    log = tmp_path / "ba_log.json"
    assert log.exists() == (ndev == 1)
    if ndev == 1:
        assert len(json.loads(log.read_text())["cost"]) == 3


def test_config_file_keys_of_the_reference(tmp_path, capsys):
    """A config file with the JAX package's keys debug, num_threads,
    use_householder_marginalization, staged_execution and reduction_alg,
    and the checkpoint and CERES-baseline keys, loads (no unused-key
    exit), and --dump-config prints them; their flags parse."""
    from rootba_tpu_torch.cli.bal import run_app

    (tmp_path / "rootba_config.toml").write_text(
        "[solver]\ndebug = true\nnum_threads = 4\n"
        "use_householder_marginalization = false\n"
        "staged_execution = false\nreduction_alg = 0\npower_order = 7\n"
        'checkpoint_path = "ck.npz"\ncheckpoint_interval = 3\n'
        'baseline_method = "lm"\ngradient_tolerance = 1e-10\n'
        "parameter_tolerance = 1e-09\nmin_lm_diagonal = 1e-05\n"
        "max_lm_diagonal = 1e+20\n")
    cwd = os.getcwd()
    try:
        assert run_app("test", ["-C", str(tmp_path), "--dump-config"]) == 0
        out = capsys.readouterr().out
        for line in ("debug = true", "num_threads = 4",
                     "use_householder_marginalization = false",
                     "staged_execution = false", "reduction_alg = 0",
                     "power_order = 7", 'checkpoint_path = "ck.npz"',
                     "checkpoint_interval = 3", 'baseline_method = "lm"',
                     "gradient_tolerance = 1e-10",
                     "parameter_tolerance = 1e-09",
                     "min_lm_diagonal = 1e-05", "max_lm_diagonal = 1e+20"):
            assert line in out, line
        assert run_app("test", ["-C", str(tmp_path), "--dump-config",
                                "--reduction-alg", "2", "--num-threads",
                                "5", "--checkpoint-interval", "2",
                                "--baseline-method", "trf"]) == 0
        out = capsys.readouterr().out
        assert "reduction_alg = 2" in out and "num_threads = 5" in out
        assert ("checkpoint_interval = 2" in out
                and 'baseline_method = "trf"' in out)
    finally:
        os.chdir(cwd)


def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the CLI asks for the card, and without one it
    raises instead of running on the CPU."""
    from rootba_tpu_torch.cli.bal import run_app

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bal = _write_problem(tmp_path / "problem.txt")
    cwd = os.getcwd()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_app("test", ["-C", str(tmp_path), "--input", str(bal)])
    finally:
        os.chdir(cwd)
    assert not (tmp_path / "ba_log.json").exists()


def test_unported_routes_raise(synthetic_problem):
    """Every route is ported: kernel_layout="einsum", which raised until
    the einsum layout came, now builds the einsum linearizer and solves
    as the flat layout's implicit mode does (same CG counts, costs
    within rel 1e-10 in float64); a layout that does not exist raises
    ValueError with the JAX package's text instead of running something
    else."""
    from rootba_tpu_torch.bal.bucketing import bucketize
    from rootba_tpu_torch.config.options import SolverOptions
    from rootba_tpu_torch.solver.lm import (
        SqrtLinearizer,
        bundle_adjust,
        create_linearizer,
    )

    bp = bucketize(synthetic_problem)
    cpu = torch.device("cpu")
    assert isinstance(create_linearizer(
        bp, SolverOptions(kernel_layout="einsum"), torch.float64, cpu),
        SqrtLinearizer)
    logs = {}
    for kw in (dict(kernel_layout="einsum"), dict(sqrt_rcs_mode="implicit")):
        s = bundle_adjust(synthetic_problem.copy(), SolverOptions(
            verbosity_level=0, max_num_iterations=5, **kw), device="cpu")
        logs[kw.popitem()[1]] = s.iterations
    a, b = logs["einsum"], logs["implicit"]
    assert ([i.linear_solver_iterations for i in a]
            == [i.linear_solver_iterations for i in b])
    np.testing.assert_allclose([i.cost.all.error for i in a],
                               [i.cost.all.error for i in b], rtol=1e-10)
    opts = SolverOptions()
    opts.kernel_layout = "planar"
    with pytest.raises(ValueError, match="unknown kernel_layout 'planar'"):
        create_linearizer(bp, opts, torch.float64, cpu)


@pytest.mark.parametrize("argv,symmetric", [
    (["--sqrt-rcs-mode", "bsr"], False),
    (["--sqrt-rcs-mode", "bsr", "--bsr-pack-max-gb", "0"], True),
    (["--dense-rcs-max-cameras", "4"], False)])
def test_cli_cpu_runs_bsr_mode(tmp_path, monkeypatch, argv, symmetric):
    """BSR mode through the CLI on the CPU: asked for, with the half
    table (--bsr-pack-max-gb 0), and picked by 'auto' above
    --dense-rcs-max-cameras; every linear solve goes through the
    block-sparse operator of the regime asked for."""
    from rootba_tpu_torch.cli.bal import run_app
    from rootba_tpu_torch.solver import sqrt_flat

    regimes = []
    real = sqrt_flat.bsr_table_matvec

    def spy(table, diag, bsr, sym):
        regimes.append(sym)
        return real(table, diag, bsr, sym)

    monkeypatch.setattr(sqrt_flat, "bsr_table_matvec", spy)
    bal = _write_problem(tmp_path / "problem.txt")
    cwd = os.getcwd()
    try:
        rc = run_app("test", ["-C", str(tmp_path), "--input", str(bal),
                              "--device", "cpu", "--max-num-iterations",
                              "3", "--init-depth-threshold", "0.1",
                              "--quiet", *argv])
    finally:
        os.chdir(cwd)
    assert rc == 0
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert len(log["cost"]) == 4 and log["cost"][-1] < log["cost"][0]
    assert regimes and set(regimes) == {symmetric}
    assert len(regimes) == sum(1 for n in log["linear_solver_iterations"]
                               if n > 0)
