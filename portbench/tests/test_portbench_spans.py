"""The span and counter metrics (portbench/spans.py and their readers)
on the CPU: read from a traced window of a tiny cell, left out for a
program without the recorder, and their arithmetic and the idle gaps'
names on hand-made records."""

import json
import sys
import types

import pytest

from conftest import ROOT, add_tiny_cell
from portbench import spans
from portbench.trace import DeviceTrace

NEW = {"parse_s", "preprocess_s", "bucketize_s", "index_build_s",
       "sync_wait_ms", "syncs_per_iter", "lm_idle"}
OLD = {"load_s", "host_prep_s", "lm_iter_ms", "stage1_ms", "stage2_ms",
       "lsolve_ms", "lsolve_iters"}
F32_LIMITS = json.loads((ROOT / "portbench/limits/traf257.sqrt-f32.json")
                        .read_text())


def traced_tiny_run(root, capsys, traffic="sqrt-f32-20it"):
    """A --trace 1 run of a tiny cell that the span metrics list."""
    from portbench import run

    cell = add_tiny_cell(root, traffic, F32_LIMITS)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for m in manifest["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 7),
                   "--seconds", "0.1", "--trace", "1"], device="cpu",
                  root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_span_metrics_read_a_traced_window(bench_copy, capsys):
    from rootba_tpu_torch.log import trace

    res = traced_tiny_run(bench_copy, capsys)
    assert res["correct"]
    got = res["metrics"]
    # the CPU has no device trace: lm_idle reads nothing
    assert set(got) == OLD | NEW - {"lm_idle"}
    assert all(got[k]["value"] > 0 for k in NEW - {"lm_idle"})
    # the dense f32 route solves by the CG kernel's twin, which reads
    # nothing back: the attempt's read and the upload of its factors'
    # padding per attempt, and the initial cost's read per solve
    assert got["syncs_per_iter"]["value"] == pytest.approx(2 + 1 / 20)
    assert got["parse_s"]["value"] < got["load_s"]["value"]
    assert (got["bucketize_s"]["value"] + got["index_build_s"]["value"]
            < got["host_prep_s"]["value"])
    # the recorder is off again after the run
    assert trace.span("a") is trace.span("b")


def test_a_program_without_the_recorder_reports_todays_metrics(
        bench_copy, capsys, monkeypatch):
    import rootba_tpu_torch.log as log

    monkeypatch.delattr(log, "trace")
    monkeypatch.setitem(sys.modules, "rootba_tpu_torch.log.trace", None)
    assert spans.recorder() is None
    res = traced_tiny_run(bench_copy, capsys)
    assert res["correct"] and set(res["metrics"]) == OLD


def _reader(name):
    from portbench import run

    return run.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                           f"test_reader_{name}")


@pytest.fixture
def readers():
    """Every span reader, loaded as run.py loads them (which starts the
    program's recorder: stopped again after the test)."""
    from rootba_tpu_torch.log import trace

    yield {name: _reader(name) for name in NEW}
    trace.stop()


def _solve(off, parse):
    """A solve's spans from `off` seconds on: two LM attempts, a sync
    in the first attempt's pcg and in the copy back."""
    spans = [("load.parse", 0.0, parse, 0),
             ("load.normalize", 2.0, 2.2, 0), ("load.perturb", 2.2, 2.8, 0),
             ("load.filter", 2.8, 2.9, 0), ("prep.bucketize", 3.0, 3.5, 0),
             ("prep.build.pair_index", 3.5, 4.5, 0),
             ("prep.build.pair_stream", 3.5, 4.0, 1),
             ("prep.build.cam_stream", 4.0, 4.4, 1),
             ("sync.cost", 4.6, 4.7, 0),
             ("lm.attempt", 5.0, 7.0, 0), ("lm.stage1", 5.0, 5.5, 1),
             ("prep.build.cam_csr", 5.1, 5.3, 2), ("sync.pcg", 6.0, 6.2, 1),
             ("sync.attempt", 6.8, 7.0, 1), ("lm.attempt", 8.0, 9.0, 0),
             ("sync.attempt", 8.5, 8.7, 1), ("post.copy_back", 9.5, 9.9, 0),
             ("sync.copy", 9.6, 9.7, 1)]
    solve = types.SimpleNamespace(t0=off, t2=off + 10.0, lm_iterations=2)
    return solve, [(n, a + off, b + off, d) for n, a, b, d in spans]


def test_span_arithmetic_on_a_hand_made_record(readers):
    (s1, a), (s2, b) = _solve(0.0, 1.0), _solve(20.0, 2.0)
    counters = {"sync.cost": 2, "sync.pcg": 2, "sync.attempt": 4,
                "sync.copy": 2}
    ctx = types.SimpleNamespace(solves=[s1, s2], trace=None,
                                traced_solves=[],
                                program_records=((a + b, counters), None))
    got = {k: r.read(ctx) for k, r in readers.items()}
    assert got == pytest.approx(dict(
        parse_s=1.5, preprocess_s=0.9, bucketize_s=0.5,
        # the pair index with the streams in it, and the lazy camera CSR
        index_build_s=1.2,
        # pcg's and the two attempts' reads; not the cost's or the copy's
        sync_wait_ms=1e3 * 1.2 / 4,
        # every counted sync but the two in the copy back
        syncs_per_iter=8 / 4, lm_idle=None))


def test_lm_idle_reads_the_attempts_of_the_traced_solve(readers):
    solve, spans = _solve(30.0, 1.0)
    tr = DeviceTrace(ops=[("k", 35.5, 36.0), ("m", 38.0, 42.0),
                          ("k", 43.0, 44.0)], t0=30.0, t1=40.0)
    ctx = types.SimpleNamespace(solves=[], trace=tr, traced_solves=[solve],
                                program_records=(None, (spans, {})))
    # attempts 35-37 and 38-39: busy 0.5 and 1.0 of 3 seconds
    assert readers["lm_idle"].read(ctx) == pytest.approx(50.0)


def test_idle_gaps_named_by_program_spans():
    tr = DeviceTrace(ops=[("k", 31.0, 31.5), ("k", 36.0, 36.5),
                          ("m", 38.0, 40.0)], t0=30.0, t1=40.0)
    harness = [("load", 30.0, 32.0), ("host_prep", 32.0, 34.9),
               ("lm", 34.9, 40.0)]
    program = [("load.parse", 30.0, 31.9, 0),
               ("prep.build.pair_index", 33.0, 34.0, 0),
               ("prep.build.pair_stream", 33.5, 34.0, 1),
               ("lm.attempt", 35.0, 37.0, 0)]
    assert spans.name_gaps(tr.gaps(), harness, program) == [
        ["host_prep/prep.build.pair_stream", 4.5], ["lm", 1.5],
        ["load/load.parse", 1.0]]
    # without program spans, the harness's names
    assert [n for n, _ in spans.name_gaps(tr.gaps(), harness, [])] == [
        "host_prep", "lm", "load"]
