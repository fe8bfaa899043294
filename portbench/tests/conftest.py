"""Shared fixtures of the benchmark's tests: a tiny cell added to a copy
of the benchmark from new files alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(num_cams=16, num_lms=300, num_obs=1500)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


def add_tiny_cell(root: Path, traffic: str, limits: dict,
                  name: str = None) -> str:
    """Adds a tiny configuration, a cell on `traffic` and its limits to
    the benchmark copy at `root`, as new files and new entries of
    BENCHMARK.json; returns the cell's name."""
    conf = json.loads((ROOT / "portbench/configs/bal-trafalgar-257.json")
                      .read_text())
    conf.update(name="tiny", **TINY)
    (root / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    if "tiny" not in [c["name"] for c in manifest["configs"]]:
        manifest["configs"].append(dict(
            name="tiny", source="https://grail.cs.washington.edu/projects/bal/",
            file="portbench/configs/tiny.json", reduced=[],
            why="a test size"))
    name = name or f"tiny.{traffic}"
    manifest["workloads"].append(dict(name=name, config="tiny",
                                      traffic=traffic, chips=1,
                                      why="a test size"))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / f"portbench/limits/{name}.json").write_text(json.dumps(limits))
    return name


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A checkout of the benchmark alone (BENCHMARK.json and portbench/)
    under tmp_path, with TMPDIR inside it."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return root
