"""The benchmark's Venice-1778 route on the CPU at a tiny size: a twin
drawn with the bal-venice-1778 configuration's knobs and routed as the
cell venice1778.sqrt-f32 routes the published problem (the host LM
driver, the dense explicit reduced camera system, pcg), held to the
plain reference (portbench/references/bal_lm.py) under the cell's
limits; stage2's assembly timer and pair-slot counter
(rootba_tpu_torch.log.trace) and the benchmark's readers of them
(portbench/metrics/assemble_ms.py, pair_slots_m.py). Needs no JAX."""

import contextlib
import json
import types

import pytest
import torch

from portbench import run, twin
from portbench.control import control_answer
from portbench.references import bal_lm
from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
from rootba_tpu_torch.config.options import BalDatasetOptions, SolverOptions
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.log.summary import SolverSummary
from rootba_tpu_torch.solver import lm

torch.set_num_threads(1)

CELL = "venice1778.sqrt-f32"
CONF = json.loads((run.ROOT / "portbench/configs/bal-venice-1778.json")
                  .read_text())
LIMITS = json.loads((run.ROOT / f"portbench/limits/{CELL}.json")
                    .read_text())
SOLVER = json.loads((run.ROOT / "portbench/traffic/sqrt-f32-20it.json")
                    .read_text())["solver"]
DATASET = dict(CONF["dataset"], quiet=True)
# Venice's route at this size: the host driver (Venice's 5.0M
# observations are above the default 2M threshold), the dense system
# (24 <= 2048 cameras) and pcg (the CG kernel's gate takes up to 128
# cameras, so it is turned off here; Venice's 1,778 are above it)
ROUTE = dict(fused_obs_threshold=100, pallas_cg="off")
RCS = {"rcs.assemble", "rcs.assemble_s", "rcs.pair_slots"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("venice") / "venice-tiny.txt"
    twin.write_bal(twin.generate(24, 600, 3000, CONF["twin_seed"],
                                 **CONF["twin"]),
                   str(path), order_seed=2 ** 31 + 13)
    return str(path)


def _solve(path, use_double, **extra):
    """The traffic's solve on Venice's route with the recorder on:
    (problem, summary, linearizer, [(IterationSummary, counters)] per
    LM iteration), each iteration's counters recorded apart through the
    host driver's iteration callback."""
    options = run._options(SolverOptions, dict(SOLVER, use_double=use_double,
                                               **ROUTE))
    for k, v in extra.items():
        setattr(options, k, v)
    made, records = [], []
    inner_create, inner_lm = lm.create_linearizer, lm.optimize_lm

    def create(*a, **k):
        made.append(inner_create(*a, **k))
        return made[-1]

    def per_iteration(it, state, summary):
        records.append((summary.iterations[-1], trace.stop()[1]))
        trace.start()

    def host_driver(bp, options, summary=None, **k):
        return inner_lm(bp, options, summary, iteration_callback=per_iteration,
                        **k)

    problem = load_normalized_bal_problem(BalDatasetOptions(input=path,
                                                            **DATASET))
    summary = SolverSummary()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "create_linearizer", create)
        mp.setattr(lm, "optimize_lm", host_driver)
        trace.start()
        try:
            lm.bundle_adjust(problem, options, summary, device="cpu")
        finally:
            trace.stop()
    return problem, summary, made[0], records


@pytest.fixture(scope="module")
def f32(tiny):
    return _solve(tiny, False)


def _answer(problem, summary):
    return dict(obs_lm=problem.obs_lm, obs_cam=problem.obs_cam,
                obs_uv=problem.obs_uv, cam_q=problem.cam_q,
                cam_t=problem.cam_t, cam_intr=problem.cam_intr,
                lm_p=problem.lm_p,
                initial_cost=summary.initial_cost.all.error,
                final_cost=summary.final_cost.all.error)


def test_the_route_is_venices(f32):
    problem, summary, lin, records = f32
    assert problem.num_observations > ROUTE["fused_obs_threshold"]
    # the host driver ran: its callback saw every LM iteration, and its
    # linearize read stage1's failure count back
    assert len(records) == len(summary.iterations) == SOLVER[
        "max_num_iterations"] + 1
    assert all("sync.failures" in c for it, c in records[1:]
               if it.stage1_time_in_seconds > 0)
    assert lin.explicit_rcs and not lin.bsr_rcs and not lin.use_cg_kernel
    # pcg's host loop: one termination read per CG iteration
    for it, c in records[1:]:
        assert c["sync.pcg"] == it.linear_solver_iterations > 0


def test_float64_costs_equal_the_reference(tiny):
    _, summary, _, _ = _solve(tiny, True)
    ref = bal_lm.solve(bal_lm.preprocess(bal_lm.read_bal(tiny), DATASET),
                       dict(SOLVER, use_double=True),
                       SOLVER["max_num_iterations"], "cpu")
    want = [it.cost.all.error for it in summary.iterations]
    assert len(ref["costs"]) == len(want)
    assert ref["costs"] == pytest.approx(want, rel=1e-9)


def test_float32_passes_the_cells_limits_and_the_control_fails(tiny, f32):
    problem, summary, _, _ = f32
    dataset = dict(DATASET, input=tiny)
    control = control_answer(bal_lm, tiny, dataset, SOLVER, "cpu")
    got, ctl = bal_lm.judge(tiny, dataset, SOLVER,
                            SOLVER["max_num_iterations"],
                            [_answer(problem, summary), control], "cpu")
    assert all(got[k] <= lim for k, lim in LIMITS.items()), got
    assert any(ctl[k] > lim for k, lim in LIMITS.items()), ctl


def test_assembly_time_is_a_part_of_stage2(f32):
    _, _, _, records = f32
    assert not RCS & set(records[0][1])  # iteration 0 makes no attempt
    for it, c in records[1:]:
        assert c["rcs.assemble"] == 1
        assert 0 < c["rcs.assemble_s"] <= it.stage2_time_in_seconds


def test_pair_slots_are_the_stream_index_padded_slots(f32):
    from rootba_tpu_torch.bal import bucketing

    _, _, lin, records = f32
    slots = sum(wi.numel() for t in lin.pairs.wi_idx for wi in t)
    # the host twin's sub-streams: [R, W] slot ids, runs padded to W
    host = bucketing.build_pair_stream(lin.bp.buckets, lin.num_cameras)
    assert slots == sum(x.size for x in host.wi_idx) > 0
    assert all(c["rcs.pair_slots"] == slots for _, c in records[1:])


@pytest.mark.parametrize("route", ["dense", "bsr"])
def test_the_timer_adds_no_sync(tiny, route, monkeypatch):
    extra = {} if route == "dense" else dict(dense_rcs_max_cameras=0)
    _, _, lin, timed = _solve(tiny, False, **extra)
    assert lin.bsr_rcs == (route == "bsr")
    monkeypatch.setattr(trace, "timer",
                        lambda name, device: contextlib.nullcontext())
    _, _, _, untimed = _solve(tiny, False, **extra)

    def syncs(records):
        return [{k: v for k, v in c.items() if k.startswith("sync.")}
                for _, c in records]

    assert all("rcs.assemble_s" in c for _, c in timed[1:])
    assert not any("rcs.assemble_s" in c for _, c in untimed)
    assert syncs(timed) == syncs(untimed)


def _reader(name):
    return run.load_module(run.ROOT / "portbench" / "metrics" / f"{name}.py",
                           f"test_venice_reader_{name}")


@pytest.fixture
def readers():
    """The two stage2 readers, loaded as run.py loads them (which starts
    the program's recorder: stopped again after the test)."""
    yield {name: _reader(name) for name in ("assemble_ms", "pair_slots_m")}
    trace.stop()


def test_readers_on_the_route_record(f32, readers):
    _, summary, lin, records = f32
    counters = {}
    for _, c in records:
        for k, v in c.items():
            counters[k] = counters.get(k, 0) + v
    its = len(summary.iterations) - 1
    solve = types.SimpleNamespace(t0=0.0, t2=1.0, lm_iterations=its)
    ctx = types.SimpleNamespace(solves=[solve], traced_solves=[],
                                trace=None,
                                program_records=(([], counters), None))
    assemble = sum(c["rcs.assemble_s"] for _, c in records[1:])
    assert readers["assemble_ms"].read(ctx) == pytest.approx(
        1e3 * assemble / its)
    assert readers["pair_slots_m"].read(ctx) == pytest.approx(
        lin.pair_slots / 1e6)


@pytest.mark.parametrize("records", [
    # a program without the timer and counter (the parent's): its sync
    # counters only
    (([], {"sync.attempt": 20, "sync.pcg": 170}), None),
    # a program without the recorder
    (None, None)])
def test_readers_read_nothing_without_the_program_s_record(readers,
                                                            records):
    solve = types.SimpleNamespace(t0=0.0, t2=1.0, lm_iterations=20)
    ctx = types.SimpleNamespace(solves=[solve], traced_solves=[],
                                trace=None, program_records=records)
    assert all(r.read(ctx) is None for r in readers.values())


def test_a_traced_run_of_the_configuration_reports_both(tmp_path,
                                                        monkeypatch, capsys):
    """A --trace 1 run of a tiny cell of Venice's configuration, added to
    a copy of the benchmark and listed by both metrics, reports them in
    its result line, and is correct under the cell's limits."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(run.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    conf = dict(CONF, name="venice-tiny", num_cams=24, num_lms=600,
                num_obs=3000)
    (root / "portbench/configs/venice-tiny.json").write_text(
        json.dumps(conf))
    cell = "venice-tiny.sqrt-f32"
    manifest["configs"].append(dict(
        name="venice-tiny", source=CONF["source"],
        file="portbench/configs/venice-tiny.json", reduced=[],
        why="a test size"))
    manifest["workloads"].append(dict(
        name=cell, config="venice-tiny", traffic="sqrt-f32-20it", chips=1,
        why="a test size"))
    for m in manifest["per_layer"]:
        if m["name"] in ("assemble_ms", "pair_slots_m"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / f"portbench/limits/{cell}.json").write_text(json.dumps(LIMITS))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    # the tests' conftest loads JAX into this process: the run's check
    # holds it to what the run itself loads
    before = set(run.forbidden_modules())
    inner = run.forbidden_modules
    monkeypatch.setattr(run, "forbidden_modules",
                        lambda: sorted(set(inner()) - before))
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 21),
                   "--seconds", "0.1", "--trace", "1"], device="cpu",
                  root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert res["correct"]
    got = res["metrics"]
    assert got["assemble_ms"]["value"] > 0
    assert got["assemble_ms"]["value"] <= got["stage2_ms"]["value"]
    assert got["pair_slots_m"]["value"] > 0
    assert trace.span("a") is trace.span("b")  # the recorder is off again
