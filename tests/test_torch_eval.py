"""The port's evaluation tools (rootba_tpu_torch/eval) against the JAX
package's on the CPU: log IO, metrics, experiments, reports, the
viewers, the FLOP model and the batch config generator; logs and
reports read by both packages; the experiment cache kept apart; the
live viewer's solve held to a direct one. The JAX package is called only
through its numpy-only eval and log modules, so nothing compiles."""

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rootba_tpu_torch.config.options import BaLogOptions
from rootba_tpu_torch.eval.log import _parse_ubjson, load_ba_log
from rootba_tpu_torch.eval.metrics import (
    METRICS,
    cost_threshold,
    time_to_threshold,
)
from rootba_tpu_torch.log.ba_log import _to_ubjson, build_log_dict, save_log

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SOLVERS = ("SQUARE_ROOT", "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT")
FORMATS = {"JSON": "ba_log.json", "UBJSON": "ba_log.ubjson"}


def make_summary(costs=(100.0, 50.0, 30.0, 30.0), pkg="port"):
    """A solver summary of the given costs (the last step rejected), built
    with the port's log classes or, with pkg="jax", the JAX package's."""
    if pkg == "jax":
        from rootba_tpu.log import summary as m
    else:
        from rootba_tpu_torch.log import summary as m
    s = m.SolverSummary()
    for i, c in enumerate(costs):
        it = m.IterationSummary(iteration=i)
        it.cost = m.ResidualInfoHost(
            all=m.ResidualItemHost(num_obs=10, error=c, residual_sum=5.0),
            valid=m.ResidualItemHost(num_obs=9, error=c * 0.9,
                                     residual_sum=4.0))
        it.step_is_successful = i < 3  # last iteration rejected
        it.step_is_valid = True
        it.linear_solver_iterations = 5
        it.iteration_time_in_seconds = 0.1
        it.cumulative_time_in_seconds = 0.1 * (i + 1)
        it.trust_region_radius = 1e4
        it.linear_solver_type = "bal_qr"
        m.finish_iteration(s, it)
    m.finish_solve(s, "bal_qr")
    return s


def assert_same(a, b, where="log"):
    """Two loaded logs (either package's Attrs) hold the same keys and
    equal values, arrays element for element (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and a != a:
        assert isinstance(b, float) and b != b, where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def write_runs(root: Path, runs) -> None:
    """(experiment, sequence, costs) -> runs/<experiment>/<sequence>/
    with a completed ba_log.json written by the port."""
    for exp, seq, costs in runs:
        d = root / "runs" / exp / seq
        d.mkdir(parents=True)
        save_log(BaLogOptions(log_path=str(d / "ba_log.json")),
                 make_summary(costs), quiet=True)
        (d / "status.log").write_text("completed\n")


def tiny_problem(path: Path) -> Path:
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )

    write_bal_file(generate_synthetic_bal(num_cams=8, num_lms=120, seed=11),
                   str(path))
    return path


def live_problem():
    """The live viewer tests' 6-camera problem, preprocessed as bench.py
    does."""
    from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal

    p = generate_synthetic_bal(num_cams=6, num_lms=60, mean_obs_per_lm=4.0,
                               seed=5)
    p.normalize(100.0)
    p.perturb(0.0, 0.01, 0.01, 38401)
    p.filter_obs(0.1)
    return p


# ---------------------------------------------------------------------------
# tests/test_eval.py's tests on the port


def test_log_dict_schema():
    d = build_log_dict(make_summary())
    assert d["_type"] == "rootba"
    assert d["cost"] == [100.0, 50.0, 30.0, 30.0]  # rejected repeats prev
    assert d["cost_change"][3] == 0.0
    assert d["iteration"] == [0, 1, 2, 3]
    assert d["_static"]["solver"]["solver_type"] == "bal_qr"
    assert d["_static"]["solver"]["num_successful_steps"] == 2
    assert d["_static"]["solver"]["num_unsuccessful_steps"] == 1


def test_ubjson_roundtrip():
    obj = {"a": [1, 2, 3], "b": 1.5, "c": "hi", "d": True,
           "e": {"f": [1.0, -2.5]}, "g": 300, "h": 70000,
           "i": 2**40, "j": None}
    assert _parse_ubjson(_to_ubjson(obj)) == obj


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_save_and_load_log(tmp_path, fmt):
    save_log(BaLogOptions(log_path=str(tmp_path / "ba_log.json"),
                          save_log_flags=[fmt]), make_summary(), quiet=True)
    assert sorted(os.listdir(tmp_path)) == [FORMATS[fmt]]
    log = load_ba_log(str(tmp_path / FORMATS[fmt]))
    np.testing.assert_allclose(np.asarray(log["cost"]),
                               [100.0, 50.0, 30.0, 30.0])
    assert log["_static"]["solver"]["termination_type"]


def test_metrics():
    d = build_log_dict(make_summary())
    assert METRICS["cost"].value(d) == 30.0
    assert METRICS["num_iterations"].value(d) == 3
    assert METRICS["linear_solver_iterations"].value(d) == 20
    th = cost_threshold(100.0, 30.0, 0.1)
    assert th == 37.0
    assert time_to_threshold(d, 37.0) == pytest.approx(0.3)
    assert time_to_threshold(d, 1.0) == float("inf")


def test_experiments_and_report(tmp_path):
    from rootba_tpu_torch.eval.experiments import load_all
    from rootba_tpu_torch.eval.report import generate_report

    write_runs(tmp_path, [("expA", "seq1", (100.0, 40.0, 20.0)),
                          ("expA", "seq2", (200.0, 90.0, 60.0)),
                          ("expB", "seq1", (100.0, 60.0, 25.0)),
                          ("expB", "seq2", (200.0, 80.0, 55.0))])
    spec = tmp_path / "spec.toml"
    spec.write_text(f"""
[options]
base_path = "{tmp_path}"
output_path = "report"

[[experiments]]
name = "A"
display_name = "solver A"
pattern = "runs/expA/*"

[[experiments]]
name = "B"
display_name = "solver B"
pattern = "runs/expB/*"
""")
    exps = load_all(str(spec))
    assert set(exps) == {"A", "B"}
    assert exps["A"].sequences() == ["seq1", "seq2"]
    text = open(generate_report(exps, str(tmp_path / "report"))).read()
    assert "solver A" in text and "seq1" in text
    for png in ("performance_profiles.png", "convergence.png",
                "bar_total_time.png"):
        assert (tmp_path / "report" / png).exists(), png
    tex = (tmp_path / "report" / "report.tex").read_text()
    assert r"\begin{tabular}" in tex and r"\textbf{" in tex


def test_experiments_templates_and_cache(tmp_path):
    """Template/substitution expansion + spec-hash pickle caching
    (reference experiments.py:298-460 grammar, :39-48 caching)."""
    import shutil

    from rootba_tpu_torch.eval.experiments import load_all

    write_runs(tmp_path, [(f"2026_{kind}", seq, (100.0, 50.0, 25.0))
                          for kind in ("qr32", "sc32")
                          for seq in ("seq1", "seq2")])
    spec = tmp_path / "spec.toml"
    spec.write_text(f"""
[options]
base_path = "{tmp_path}"
cache_dir = "cache"

[[substitutions]]
date = "2026"

[[templates]]
_name = "exp_kind"
_arguments = ["kind"]
name = "${{kind}}"
display_name = "solver ${{kind}}"
pattern = "runs/${{date}}_${{kind}}/*"

[[experiments]]
_template = {{ _name = "exp_kind", kind = {{ _argument = "product", _value = ["qr32", "sc32"] }} }}
""")
    exps = load_all(str(spec))
    assert set(exps) == {"qr32", "sc32"}
    assert exps["qr32"].display_name == "solver qr32"
    assert exps["sc32"].sequences() == ["seq1", "seq2"]
    # warm-cache load hits the pickles (delete the run dirs to prove it)
    assert len(os.listdir(tmp_path / "cache")) == 2
    shutil.rmtree(tmp_path / "runs")
    exps2 = load_all(str(spec))
    assert exps2["sc32"].sequences() == ["seq1", "seq2"]
    assert (type(exps2["sc32"]).__module__
            == "rootba_tpu_torch.eval.experiments")


def test_html_viewer(tmp_path):
    """Interactive HTML viewer: payload buffers decode back to the
    problem's geometry; the file is self-contained (no external URLs)."""
    from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal
    from rootba_tpu_torch.eval.html_view import (
        _reprojections,
        export_html,
        viewer_payload,
    )

    p = generate_synthetic_bal(num_cams=5, num_lms=60, mean_obs_per_lm=3.0,
                               seed=3)
    payload = viewer_payload(p)

    def unpack(b64, shape):
        return np.frombuffer(base64.b64decode(b64),
                             dtype="<f4").reshape(shape)

    np.testing.assert_allclose(unpack(payload["points"], (-1, 3)), p.lm_p,
                               rtol=1e-6)
    assert payload["num_cams"] == 5
    # overlay offsets partition the per-camera obs
    assert payload["ov_off"][-1] == p.num_observations
    assert unpack(payload["ov_obs"], (-1, 2)).shape[0] == p.num_observations
    assert np.isfinite(_reprojections(p)).all()

    out = tmp_path / "map.html"
    export_html(p, str(out))
    html = out.read_text()
    assert "http://" not in html and "https://" not in html
    assert "rootba_tpu map" in html


def test_live_view_server():
    """The live viewer on the CPU, on a free port: POST /optimize solves
    on a thread, and the final /state (iteration counter, done, cost,
    points) equals a direct `optimize_lm` of the same problem and
    options. The solve takes milliseconds here, so the polls see the
    end, not each iteration."""
    from rootba_tpu_torch.bal.bucketing import bucketize
    from rootba_tpu_torch.config.options import SolverOptions
    from rootba_tpu_torch.eval import live_view
    from rootba_tpu_torch.solver.lm import optimize_lm

    p = live_problem()
    opts = SolverOptions(use_double=False, lm_loop="host",
                         verbosity_level=0, max_num_iterations=3)
    srv = live_view.make_server(p, opts, port=0, device="cpu")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        def get(path):
            return urllib.request.urlopen(base + path, timeout=10).read()

        html = get("/").decode()
        assert "bopt" in html and "optimize" in html
        first = json.loads(get("/state"))
        assert first["it"] == -1 and not first["done"]
        req = urllib.request.Request(base + "/optimize", method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=10).read())[
            "status"] == "started"
        deadline = time.monotonic() + 120
        while True:
            raw = get("/state?since=-1")
            assert b"NaN" not in raw  # NaN is invalid JSON; browsers reject
            d = json.loads(raw)
            if d["done"]:
                break
            assert time.monotonic() < deadline, "live solve did not finish"
            time.sleep(0.02)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10)
    assert not t.is_alive()

    bp = bucketize(p.copy(), pow2_from=opts.bucket_pow2_from)
    state, s = optimize_lm(bp, opts, device=torch.device("cpu"))
    work = p.copy()
    want = live_view._snapshot(work, bp, state, 400_000)
    assert d["error"] is None and not d["running"]
    # the callback's counter after the last iteration: iterations 0..3
    assert d["it"] == len(s.iterations) == 4
    assert d["cost"] == s.iterations[-1].cost.all.error
    assert d["cost"] < s.iterations[0].cost.all.error
    assert d["payload"]["points"] == want["points"]
    assert d["payload"]["cam_c"] == want["cam_c"]


def test_batch_config_generator(tmp_path):
    """scripts/generate-batch-configs.py's configs load into the port's
    options (config/options.load_toml + update_from_dict) with no
    unknown key."""
    from rootba_tpu_torch.config.options import (
        BalAppOptions,
        SolverType,
        load_toml,
        update_from_dict,
    )

    (tmp_path / "rootba_batch_config.toml").write_text("""
[dataset]
input = "x.txt"

[solver]
max_num_iterations = 5

[_batch]
revision = "r1"

[_batch.config.qr]
solver = { solver_type = "SQUARE_ROOT" }

[_batch.config.sc]
solver = { solver_type = "SCHUR_COMPLEMENT" }

[_batch.config.d1]
dataset = { input = "a.txt" }

[_batch.alternatives]
solvers = ["qr", "sc"]

[_batch.combinations]
combo = ["d1", "solvers"]
""")
    script = REPO / "scripts" / "generate-batch-configs.py"
    subprocess.run([sys.executable, str(script), str(tmp_path)], check=True,
                   capture_output=True)
    for name, solver in (("qr", SolverType.SQUARE_ROOT),
                         ("sc", SolverType.SCHUR_COMPLEMENT)):
        path = tmp_path / "r1" / "combo" / f"d1_{name}" / "rootba_config.toml"
        unknown = []
        opts = update_from_dict(BalAppOptions(), load_toml(str(path)),
                                unknown=unknown)
        assert unknown == []
        assert opts.solver.solver_type == solver
        assert opts.solver.max_num_iterations == 5
        assert opts.dataset.input == "a.txt"


# ---------------------------------------------------------------------------
# logs and reports across the two packages


@pytest.fixture(scope="module")
def cli_logs(tmp_path_factory):
    """The port's CLI on the CPU, 4 f32 LM iterations of the tiny problem
    with each solver, writing JSON and UBJSON: {solver: run dir}."""
    from rootba_tpu_torch.cli.bal import run_app

    root = tmp_path_factory.mktemp("cli_logs")
    bal = tiny_problem(root / "problem.txt")
    dirs = {}
    cwd = os.getcwd()
    try:
        for solver in SOLVERS:
            wd = root / "runs" / solver / "tiny"
            wd.mkdir(parents=True)
            rc = run_app("test", [
                "-C", str(wd), "--input", str(bal), "--device", "cpu",
                "--use-double", "false", "--max-num-iterations", "4",
                "--init-depth-threshold", "0.1", "--quiet",
                "--verbosity-level", "0",
                "--log-save-log-flags", "JSON", "UBJSON"],
                forced_solver_type=solver)
            assert rc == 0, solver
            dirs[solver] = wd
    finally:
        os.chdir(cwd)
    return dirs


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("solver", SOLVERS)
def test_port_cli_logs_read_by_both_packages(cli_logs, solver, fmt):
    """Both packages' load_ba_log read the port's CLI log of each solver
    to the same columns and _static blob."""
    from rootba_tpu.eval.log import load_ba_log as jax_load

    path = str(cli_logs[solver] / FORMATS[fmt])
    port, jax = load_ba_log(path), jax_load(path)
    assert_same(port, jax)
    assert len(port["cost"]) == 5 and port["cost"][-1] < port["cost"][0]
    want = {"SQUARE_ROOT": "bal_qr", "SCHUR_COMPLEMENT": "bal_sc",
            "POWER_SCHUR_COMPLEMENT": "bal_power_sc"}[solver]
    assert port["_static"]["solver"]["solver_type"] == want
    # the JSON and the UBJSON file of one run hold the same columns
    other = load_ba_log(str(cli_logs[solver] / FORMATS[
        "UBJSON" if fmt == "JSON" else "JSON"]))
    np.testing.assert_array_equal(other["cost"], port["cost"])


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_jax_logs_read_by_the_port(tmp_path, fmt):
    """The JAX package's save_log output reads in the port as in the JAX
    package."""
    from rootba_tpu.config.options import BaLogOptions as JaxLogOptions
    from rootba_tpu.eval.log import load_ba_log as jax_load
    from rootba_tpu.log.ba_log import save_log as jax_save

    jax_save(JaxLogOptions(log_path=str(tmp_path / "ba_log.json"),
                           save_log_flags=[fmt]),
             make_summary((90.0, 70.0, 65.0, 65.0), pkg="jax"), quiet=True)
    path = str(tmp_path / FORMATS[fmt])
    port = load_ba_log(path)
    assert_same(port, jax_load(path))
    np.testing.assert_array_equal(port["cost"], [90.0, 70.0, 65.0, 65.0])


def test_reports_of_both_packages_are_identical(cli_logs, tmp_path):
    """load_all + generate_report of both packages on the same run
    directories (the port's CLI logs of three solvers, and logs written
    by each package's save_log), cache off: the same report.md and
    report.tex, and the same metric and time-to-threshold values."""
    from rootba_tpu.eval import experiments as jax_exps
    from rootba_tpu.eval import metrics as jax_metrics
    from rootba_tpu.eval import report as jax_report
    from rootba_tpu.log.ba_log import save_log as jax_save
    from rootba_tpu.config.options import BaLogOptions as JaxLogOptions
    from rootba_tpu_torch.eval import experiments, report

    root = cli_logs[SOLVERS[0]].parent.parent
    for i, solver in enumerate(SOLVERS):
        d = root / solver / "synthetic"
        d.mkdir(exist_ok=True)
        costs = (100.0, 60.0 - i, 40.0 + i, 40.0 + i)
        if i == 1:  # one of them written by the JAX package
            jax_save(JaxLogOptions(log_path=str(d / "ba_log.json")),
                     make_summary(costs, pkg="jax"), quiet=True)
        else:
            save_log(BaLogOptions(log_path=str(d / "ba_log.json")),
                     make_summary(costs), quiet=True)
    spec = tmp_path / "spec.toml"
    spec.write_text(f'[options]\nbase_path = "{root.parent}"\n'
                    f'cache_dir = "cache"\n' + "".join(
                        f'\n[[experiments]]\nname = "{s.lower()}"\n'
                        f'display_name = "{s} f32"\npattern = "runs/{s}/*"\n'
                        for s in SOLVERS))
    port = experiments.load_all(str(spec), use_cache=False)
    jax = jax_exps.load_all(str(spec), use_cache=False)
    assert not (root.parent / "cache").exists()
    assert list(port) == list(jax) == [s.lower() for s in SOLVERS]
    texts = {}
    for name, mod, exps in (("port", report, port), ("jax", jax_report, jax)):
        out = tmp_path / name
        mod.generate_report(exps, str(out))
        texts[name] = [(out / f).read_text() for f in ("report.md",
                                                       "report.tex")]
    assert texts["port"] == texts["jax"]
    md = texts["port"][0]
    assert "synthetic" in md and "tiny" in md and "SQUARE_ROOT f32" in md
    for e in port:
        assert port[e].sequences() == jax[e].sequences() == ["synthetic",
                                                             "tiny"]
        for seq, run in port[e].runs.items():
            jrun = jax[e].runs[seq]
            assert run.status == jrun.status == "completed"
            for m in METRICS:
                a = METRICS[m].value(run.log)
                b = jax_metrics.METRICS[m].value(jrun.log)
                assert a == b or (a != a and b != b), (e, seq, m)
            cost = np.asarray(run.log["cost"])
            th = cost_threshold(float(cost[0]), float(cost.min()), 0.01)
            assert th == jax_metrics.cost_threshold(float(cost[0]),
                                                    float(cost.min()), 0.01)
            assert (time_to_threshold(run.log, th)
                    == jax_metrics.time_to_threshold(jrun.log, th))


def test_experiment_cache_is_the_ports_own(tmp_path):
    """The JAX package's load_all writes its pickle cache; the port's
    load_all of the same spec in a fresh process returns the same
    experiments, writes its own cache files beside them (the package is
    part of the hashed key) and reads them back, and never imports jax
    or the JAX package (as unpickling a JAX-written file would)."""
    from rootba_tpu.eval import experiments as jax_exps
    from rootba_tpu_torch.eval import experiments

    write_runs(tmp_path, [("qr", "seq1", (100.0, 50.0, 25.0)),
                          ("qr", "seq2", (80.0, 40.0, 30.0)),
                          ("sc", "seq1", (100.0, 55.0, 26.0))])
    spec = tmp_path / "spec.toml"
    spec.write_text(f"""
[options]
base_path = "{tmp_path}"
cache_dir = "cache"

[[experiments]]
name = "qr"
pattern = "runs/qr/*"

[[experiments]]
name = "sc"
pattern = "runs/sc/*"
""")
    jax = jax_exps.load_all(str(spec))
    cache = tmp_path / "cache"
    jax_files = {f: (cache / f).read_bytes() for f in os.listdir(cache)}
    assert len(jax_files) == 2
    key = {"pattern": "runs/qr/*"}
    assert (experiments._spec_hash(key, str(tmp_path))
            != jax_exps._spec_hash(key, str(tmp_path)))

    prog = f"""
import json, os, shutil, sys
sys.path.insert(0, {str(REPO)!r})
from rootba_tpu_torch.eval.experiments import load_all

def summary(exps):
    return {{n: [e.display_name, {{s: [r.status, [float(c) for c in
                                           r.log["cost"]]]
                                  for s, r in sorted(e.runs.items())}}]
            for n, e in exps.items()}}

first = summary(load_all({str(spec)!r}))
files = sorted(os.listdir({str(cache)!r}))
shutil.rmtree({str(tmp_path / "runs")!r})
again = summary(load_all({str(spec)!r}))  # from the port's own pickles
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "rootba_tpu" or m.startswith("rootba_tpu.")]
print(json.dumps(dict(first=first, again=again, files=files, bad=bad)))
"""
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    want = {n: [e.display_name, {s: [r.status, [float(c) for c in
                                                r.log["cost"]]]
                                 for s, r in sorted(e.runs.items())}]
            for n, e in jax.items()}
    assert out["first"] == out["again"] == want
    ours = sorted(set(out["files"]) - set(jax_files))
    assert len(ours) == 2 and len(out["files"]) == 4
    assert [f.split("-")[0] for f in ours] == ["qr", "sc"]
    assert {f: (cache / f).read_bytes() for f in jax_files} == jax_files


# ---------------------------------------------------------------------------
# the viewers, the FLOP model and the entry points


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_snapshot_of_tensors(dtype):
    """_snapshot brings each state tensor to the host before
    scatter_landmarks (which numpy cannot do for a CUDA tensor): on a CPU
    state it equals scatter_landmarks of the state's numpy copy, and its
    payload is the viewer payload of that problem."""
    from rootba_tpu_torch.bal.bucketing import bucketize, scatter_landmarks
    from rootba_tpu_torch.eval.html_view import viewer_payload
    from rootba_tpu_torch.eval.live_view import _snapshot
    from rootba_tpu_torch.solver.lm import initial_state

    p = live_problem()
    bp = bucketize(p.copy())
    st = initial_state(bp, dtype, torch.device("cpu"))
    st = st._replace(lm_ps=[x + 0.5 for x in st.lm_ps])
    work = p.copy()
    payload = _snapshot(work, bp, st, 400_000)
    lm = scatter_landmarks(bp, [x.numpy() for x in st.lm_ps])
    np.testing.assert_array_equal(work.lm_p, lm)
    np.testing.assert_array_equal(work.cam_q, st.cams.q.double().numpy())
    np.testing.assert_array_equal(work.cam_t, st.cams.t.double().numpy())
    np.testing.assert_array_equal(work.cam_intr,
                                  st.cams.intr.double().numpy())
    assert not np.array_equal(work.lm_p, p.lm_p)
    assert payload == viewer_payload(work)


def test_viewers_and_flop_model_equal_the_jax_packages(tmp_path, capsys):
    """The HTML payload, the PLY export, the camera centers and the QR vs
    SC op counts equal the JAX package's on the same problem."""
    from dataclasses import astuple

    from rootba_tpu.bal.synthetic import generate_synthetic_bal as jax_gen
    from rootba_tpu.eval import html_view as jax_html
    from rootba_tpu.eval import num_ops as jax_ops
    from rootba_tpu.eval import view as jax_view
    from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal
    from rootba_tpu_torch.eval import html_view, num_ops, view

    kw = dict(num_cams=7, num_lms=90, mean_obs_per_lm=3.5, seed=4)
    p, jp = generate_synthetic_bal(**kw), jax_gen(**kw)
    assert html_view.viewer_payload(p) == jax_html.viewer_payload(jp)
    np.testing.assert_array_equal(view.camera_centers(p),
                                  jax_view.camera_centers(jp))
    view.export_ply(p, str(tmp_path / "port.ply"))
    jax_view.export_ply(jp, str(tmp_path / "jax.ply"))
    assert ((tmp_path / "port.ply").read_text()
            == (tmp_path / "jax.ply").read_text())
    for n in (2, 3, 7, 40):
        for fn in ("qr_counts", "sc_counts"):
            assert (astuple(getattr(num_ops, fn)(n))
                    == astuple(getattr(jax_ops, fn)(n))), (fn, n)
    counts = p.obs_per_landmark()
    assert num_ops.summarize(counts, 12.0) == jax_ops.summarize(counts, 12.0)
    capsys.readouterr()


def test_entry_points_on_the_cpu(cli_logs, tmp_path, capsys):
    """Each eval entry point runs on the port's loader and writes its
    output: generate_tables, plot_logs, html_view, view, num_ops (whose
    text equals the JAX package's on the same file)."""
    from rootba_tpu.eval import num_ops as jax_ops
    from rootba_tpu_torch.eval import (
        generate_tables,
        html_view,
        num_ops,
        plot_logs,
        view,
    )

    bal = tiny_problem(tmp_path / "problem.txt")
    root = cli_logs[SOLVERS[0]].parent.parent
    spec = tmp_path / "spec.toml"
    spec.write_text(f'[options]\nbase_path = "{root.parent}"\n'
                    f'output_path = "{tmp_path / "report"}"\n'
                    f'metrics = ["cost", "num_iterations"]\n'
                    f'\n[[experiments]]\nname = "qr"\n'
                    f'pattern = "runs/SQUARE_ROOT/*"\n')
    assert generate_tables.main([str(spec), "--no-cache"]) == 0
    assert "report written to" in capsys.readouterr().out
    assert "| qr: final cost | qr: #it |" in (
        tmp_path / "report" / "report.md").read_text()
    assert plot_logs.main([str(cli_logs[s]) for s in SOLVERS]
                          + ["--save", str(tmp_path / "logs.png")]) == 0
    assert html_view.main([str(bal), "-o", str(tmp_path / "m.html")]) == 0
    assert view.main([str(bal), "--ply", str(tmp_path / "m.ply"),
                      "--png", str(tmp_path / "m.png")]) == 0
    for f in ("logs.png", "m.html", "m.ply", "m.png"):
        assert (tmp_path / f).stat().st_size > 0, f
    capsys.readouterr()
    assert num_ops.main([str(bal)]) == 0
    ours = capsys.readouterr().out
    assert jax_ops.main([str(bal)]) == 0
    assert ours == capsys.readouterr().out and "TOTAL per LM" in ours


def test_live_view_asks_for_the_card(tmp_path):
    """live_view's --device defaults to the card and, without one, raises
    before the server starts (no fall back to the CPU)."""
    from rootba_tpu_torch.eval import live_view

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bal = tiny_problem(tmp_path / "problem.txt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        live_view.main([str(bal), "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        live_view.make_server(live_problem(), port=0)
