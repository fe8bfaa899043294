"""The port's span and counter recorder (rootba_tpu_torch.log.trace) on
the CPU: off by default, and in a whole load and solve with it on, the
spans of every route's load, index builds, LM attempts and host reads,
the same in both LM drivers. Needs no JAX."""

import collections
import time

import pytest
import torch

from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
from rootba_tpu_torch.bal.synthetic import (
    generate_synthetic_bal,
    write_bal_file,
)
from rootba_tpu_torch.config.options import (
    BalDatasetOptions,
    SolverOptions,
    SolverType,
)
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.log.summary import SolverSummary
from rootba_tpu_torch.solver.lm import bundle_adjust

torch.set_num_threads(1)

COMMON = {"load.parse", "load.normalize", "load.perturb", "load.filter",
          "prep.bucketize", "prep.build.bucket_index", "prep.state",
          "post.copy_back", "lm.attempt", "lm.stage1", "lm.stage2",
          "lm.lsolve", "lm.bsub", "lm.err", "sync.cost", "sync.attempt"}
# the stream index, built on the device: its reads of sizes and its pair
# list are sync.pair_stream
STREAMS = {"prep.build.pair_index", "prep.build.pair_stream",
           "prep.build.cam_stream", "sync.pair_stream"}
# pcg's reads, and the upload of the CG count and termination that it
# returns on the host
PCG = {"sync.pcg", "sync.pcg_norm", "sync.pcg_setup", "sync.attempt_upload"}
# the explicit systems' assembly timer (its count and seconds) and the
# pair slots it folds: counters with no span
RCS = {"rcs.assemble", "rcs.assemble_s", "rcs.pair_slots"}
# the perturbation's calls and polar candidates, counted inside
# load.perturb where the load perturbs: counters with no span
PERTURB = {"load.perturb_calls", "load.perturb_candidates"}
# the dataset options a route sets (the others are solver options)
DATASET = {"rotation_sigma", "translation_sigma", "point_sigma"}
# route: (options, the names it records besides COMMON; the dense f32
# route solves by the CG kernel (its twin here), which reads nothing
# back; only its factors' padding is uploaded)
ROUTES = {
    "dense": (dict(), STREAMS | {"sync.k3_planes"}),
    "perturbed": (dict(translation_sigma=0.01, point_sigma=0.01),
                  STREAMS | {"sync.k3_planes"}),
    "implicit": (dict(sqrt_rcs_mode="implicit"),
                 {"prep.build.cam_csr"} | PCG),
    "bsr": (dict(dense_rcs_max_cameras=0),
            STREAMS | {"prep.build.bsr_matvec"} | PCG),
    "sc": (dict(solver_type=SolverType.SCHUR_COMPLEMENT,
                dense_rcs_max_cameras=0),
           {"prep.build.pair_structure", "prep.build.cam_csr"} | PCG),
    "poba": (dict(solver_type=SolverType.POWER_SCHUR_COMPLEMENT),
             STREAMS | {"prep.build.cam_csr", "sync.power_series",
                        "sync.attempt_upload"}),
}


@pytest.fixture(scope="module")
def bal_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "problem.txt"
    write_bal_file(generate_synthetic_bal(num_cams=12, num_lms=200,
                                          mean_obs_per_lm=4.5, seed=3),
                   str(path))
    return str(path)


def _solve(path, lm_loop, **extra):
    """Load and solve with the recorder on: (spans, counters, summary,
    monotonic times before and after)."""
    options = SolverOptions(verbosity_level=0, max_num_iterations=4,
                            use_double=False, lm_loop=lm_loop)
    dataset = BalDatasetOptions(input=path, quiet=True)
    for k, v in extra.items():
        setattr(dataset if k in DATASET else options, k, v)
    trace.start()
    t0 = time.monotonic()
    problem = load_normalized_bal_problem(dataset)
    summary = SolverSummary()
    bundle_adjust(problem, options, summary, device="cpu")
    t1 = time.monotonic()
    spans, counters = trace.stop()
    return spans, counters, summary, (t0, t1)


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route(request, bal_file):
    extra, names = ROUTES[request.param]
    runs = {loop: _solve(bal_file, loop, **extra)
            for loop in ("fused", "host")}
    return request.param, COMMON | names, runs


def test_off_by_default_and_a_solve_records_nothing(bal_file):
    assert (trace.span("a") is trace.span("b") is trace.sync("c")
            is trace.timer("d", torch.device("cpu")))
    problem = load_normalized_bal_problem(
        BalDatasetOptions(input=bal_file, quiet=True))
    bundle_adjust(problem, SolverOptions(verbosity_level=0,
                                         max_num_iterations=2),
                  device="cpu")
    assert trace.stop() == ([], {})


def test_start_clears_the_previous_record():
    trace.start()
    with trace.span("old"):
        trace.count("old")
    trace.start()
    with trace.span("outer"):
        with trace.sync("site"):
            pass
    trace.count("n", 2)
    spans, counters = trace.stop()
    assert [(s[0], s[3]) for s in spans] == [("outer", 0), ("sync.site", 1)]
    assert counters == {"sync.site": 1, "n": 2}


def test_timer_and_counter_record_only_while_on():
    cpu = torch.device("cpu")
    with trace.timer("t", cpu):
        trace.count("n")
    trace.settle()
    assert trace.stop() == ([], {})
    trace.start()
    with trace.timer("t", cpu):
        time.sleep(0.002)
    with trace.timer("t", cpu):
        trace.count("n", 3)
    trace.settle()
    spans, counters = trace.stop()
    assert spans == [] and set(counters) == {"t", "t_s", "n"}
    assert counters["t"] == 2 and counters["n"] == 3
    assert 0.002 <= counters["t_s"] < 1.0
    with trace.timer("t", cpu):
        pass
    assert trace.stop() == ([], {})


def test_every_name_of_the_route(route):
    name, names, runs = route
    spans, counters, _, _ = runs["fused"]
    assert {s[0] for s in spans} == names
    # the explicit SQUARE_ROOT systems time their assembly and count its
    # pair slots; a perturbing load counts its draws
    assert set(counters) == (
        {n for n in names if n.startswith("sync.")}
        | (RCS if name in ("dense", "perturbed", "bsr") else set())
        | (PERTURB if name == "perturbed" else set()))
    assert all(counters[n] == sum(s[0] == n for s in spans)
               for n in counters if n not in RCS | PERTURB)
    # the load's steps, outermost and in turn: load.perturb wraps the
    # perturbation between the normalisation and the filter
    load = [s for s in spans if s[0].startswith("load.")]
    assert [s[0] for s in load] == ["load.parse", "load.normalize",
                                    "load.perturb", "load.filter"]
    assert all(s[3] == 0 for s in load)
    assert all(a[2] <= b[1] for a, b in zip(load, load[1:]))


def test_stages_nest_in_attempts(route):
    for spans, _, summary, _ in route[2].values():
        attempts = [s for s in spans if s[0] == "lm.attempt"]
        assert len(attempts) == len(summary.iterations) - 1
        for s in spans:
            if s[0].startswith("lm.") and s[0] != "lm.attempt":
                assert s[3] >= 1 and any(a[1] <= s[1] and s[2] <= a[2]
                                         for a in attempts)


def test_host_reads_counted(route):
    name, _, runs = route
    for _, counters, summary, _ in runs.values():
        its = summary.iterations[1:]
        cg = sum(it.linear_solver_iterations for it in its)
        assert counters["sync.attempt"] == len(its)
        if name in ("dense", "perturbed", "bsr"):
            # one assembly an attempt, inside stage2's time
            assert counters["rcs.assemble"] == len(its)
            assert 0 < counters["rcs.assemble_s"] <= sum(
                it.stage2_time_in_seconds for it in its)
            assert counters["rcs.pair_slots"] > 0
        if "sync.pcg" in counters:
            # one read of the termination per CG iteration, one of |b|
            # and one upload per solve
            assert counters["sync.pcg"] == cg
            assert (counters["sync.pcg_norm"] == counters["sync.pcg_setup"]
                    == len(its))
        if name == "poba":
            assert counters["sync.power_series"] == cg
        if name in ("dense", "perturbed"):
            assert counters["sync.k3_planes"] == len(its)
        else:
            assert counters["sync.attempt_upload"] == 2 * len(its)


def test_spans_on_the_monotonic_clock(route):
    for spans, _, _, (t0, t1) in route[2].values():
        assert spans and all(t0 <= s[1] <= s[2] <= t1 for s in spans)
        assert [s[1] for s in spans] == sorted(s[1] for s in spans)


def test_both_drivers_record_the_same_names(route):
    runs = route[2]
    fused = collections.Counter(s[0] for s in runs["fused"][0])
    host = collections.Counter(s[0] for s in runs["host"][0])
    # the host driver alone reads stage1's failure count back
    assert host.pop("sync.failures") == fused["lm.stage1"]
    assert host == fused


def _syncs_per_iter(spans, counters, summary):
    """portbench's syncs_per_iter: sync counters less the syncs inside
    an outermost load, prep or post span, per LM iteration."""
    outer = [s for s in spans if s[3] == 0
             and s[0].startswith(("load.", "prep.", "post."))]
    inside = sum(1 for s in spans if s[0].startswith("sync.") and any(
        o[1] <= s[1] and s[2] <= o[2] for o in outer))
    n = sum(v for k, v in counters.items() if k.startswith("sync."))
    return (n - inside) / (len(summary.iterations) - 1)


def test_pair_stream_syncs_stay_in_its_build(route, bal_file, monkeypatch):
    """The device build's reads are counted, all inside its
    prep.build.pair_stream span, so syncs_per_iter is that of a solve on
    the host build (read nothing)."""
    name, names, runs = route
    if "sync.pair_stream" not in names:
        # the routes that build no pair stream read nothing of it
        assert all("sync.pair_stream" not in r[1] for r in runs.values())
        return
    from rootba_tpu_torch.solver import explicit_sc, sqrt_flat
    from tests.test_torch_pair_stream_device import _host_build_pair_index

    for spans, counters, _, _ in runs.values():
        builds = [s for s in spans if s[0] == "prep.build.pair_stream"]
        reads = [s for s in spans if s[0] == "sync.pair_stream"]
        # the pair count, the slot total, a bucket's counts, the pair list
        assert counters["sync.pair_stream"] == len(reads) >= 4
        assert len(builds) == 1 and all(
            builds[0][1] <= s[1] and s[2] <= builds[0][2] for s in reads)

    monkeypatch.setattr(sqrt_flat, "build_pair_index",
                        _host_build_pair_index)
    monkeypatch.setattr(explicit_sc, "build_pair_index",
                        _host_build_pair_index)
    extra = ROUTES[name][0]
    spans, counters, summary, _ = runs["fused"]
    h_spans, h_counters, h_summary, _ = _solve(bal_file, "fused", **extra)
    assert "sync.pair_stream" not in h_counters
    assert (_syncs_per_iter(spans, counters, summary)
            == _syncs_per_iter(h_spans, h_counters, h_summary))
