"""BENCHMARK.json against the benchmark contract's rules, and every file
it names found by name."""

import json
import math
import re

from conftest import ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert all(line(w) for w in M["command"]) and len(M["command"]) <= 32
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    names = [c["name"] for c in M["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and PATH.match(c["file"])
        assert c["name"] in used and len(c["reduced"]) <= 16
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert (ROOT / "portbench/references"
                / f"{conf['reference']}.py").is_file()
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_workloads_and_their_files():
    ws = M["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (ROOT / f"portbench/traffic/{w['traffic']}.json").is_file()
        limits = json.loads((ROOT / f"portbench/limits/{w['name']}.json")
                            .read_text())
        assert all(isinstance(v, (int, float)) and math.isfinite(v)
                   and v >= 0 for v in limits.values())


def test_metrics():
    e2e, per = M["end_to_end"], M["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in M["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / f"portbench/metrics/{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        def mine(m):
            return w in m.get("workloads", cells)
        mine_e2e = [m["name"] for m in e2e if mine(m)]
        assert "setup_s" in mine_e2e and len(mine_e2e) >= 2
        assert any(mine(m) for m in per)


def test_adding_a_cell_needs_new_files_only(bench_copy):
    from conftest import add_tiny_cell
    from portbench import run

    before = {p: p.read_bytes() for p in (bench_copy / "portbench").rglob("*")
              if p.is_file()}
    name = add_tiny_cell(bench_copy, "sqrt-f32-20it",
                         {"obs_mismatch": 0, "solve_gap": 1e-3})
    after = {p: p.read_bytes() for p in (bench_copy / "portbench").rglob("*")
             if p.is_file()}
    assert all(after[p] == b for p, b in before.items())
    cell = run.Cell(json.loads((bench_copy / "BENCHMARK.json").read_text()),
                    name, bench_copy)
    assert cell.config["num_cams"] == 16 and cell.limits["solve_gap"] == 1e-3
    assert {m["name"] for m in cell.end_to_end} == {"solve_s", "setup_s"}
