"""The port's host formats against the JAX package's, on the CPU: the
reference's `.cereal` binary layout (bal/rootba_io.py), the bundler
reader, the native BAL tokenizer (native/runtime.py, built here with
g++) and their routes through the loader and the CLI."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from rootba_tpu.bal import problem as JP
from rootba_tpu.bal import rootba_io as jio
from rootba_tpu.bal.synthetic import generate_synthetic_bal, write_bal_file
from rootba_tpu_torch.bal import problem as TP
from rootba_tpu_torch.bal import rootba_io as tio
from rootba_tpu_torch.native import runtime as native

torch.set_num_threads(1)

FIELDS = ("cam_q", "cam_t", "cam_intr", "lm_p", "obs_lm", "obs_cam",
          "obs_uv")


def _same_problem(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _problem(seed=11):
    p = generate_synthetic_bal(num_cams=9, num_lms=60, seed=seed)
    p.normalize(100.0)
    p.perturb(0.0, 0.01, 0.01, 38401)
    p.filter_obs(0.1)
    return p


def test_cereal_bytes_equal_jax(tmp_path):
    """save_rootba writes the JAX package's bytes, and the JAX golden
    layout of tests/test_problem.py::test_cereal_golden_bytes."""
    p = _problem()
    tio.save_rootba(p, str(tmp_path / "t.cereal"))
    jio.save_rootba(p, str(tmp_path / "j.cereal"))
    assert ((tmp_path / "t.cereal").read_bytes()
            == (tmp_path / "j.cereal").read_bytes())

    g = TP.BalProblem(
        cam_q=np.array([[1.0, 0.0, 0.0, 0.0]]),
        cam_t=np.array([[1.5, -2.0, 3.25]]),
        cam_intr=np.array([[500.0, 1e-3, -2e-5]]),
        lm_p=np.array([[0.5, 0.25, -1.0], [4.0, 5.0, 6.0]]),
        obs_lm=np.array([0, 1]), obs_cam=np.array([0, 0]),
        obs_uv=np.array([[1.0, 2.0], [-3.0, 4.0]]), quiet=True)
    tio.save_rootba(g, str(tmp_path / "g.cereal"))
    exp = (struct.pack("<Q", 18) + b"rootba::BalProblem"
           + struct.pack("<Q", 3) + b"1.0" + struct.pack("<Q", 1)
           + struct.pack("<3d", 1.5, -2.0, 3.25)
           + struct.pack("<4d", 0.0, 0.0, 0.0, 1.0)
           + struct.pack("<3d", 500.0, 1e-3, -2e-5) + struct.pack("<Q", 2)
           + struct.pack("<3d", 0.5, 0.25, -1.0) + struct.pack("<Q", 1)
           + struct.pack("<i", 0) + struct.pack("<2d", 1.0, 2.0)
           + struct.pack("<3d", 4.0, 5.0, 6.0) + struct.pack("<Q", 1)
           + struct.pack("<i", 0) + struct.pack("<2d", -3.0, 4.0))
    assert (tmp_path / "g.cereal").read_bytes() == exp


def test_load_rootba_equals_jax(tmp_path):
    """load_rootba reads what the JAX package reads, exactly, and rejects
    what it rejects."""
    p = _problem(seed=4)
    path = str(tmp_path / "p.cereal")
    jio.save_rootba(p, path)
    t, j = tio.load_rootba(path, quiet=True), jio.load_rootba(path,
                                                              quiet=True)
    _same_problem(t, j)
    _same_problem(t, p)

    bad = tmp_path / "bad.cereal"
    bad.write_bytes(struct.pack("<Q", 5) + b"nope!"
                    + struct.pack("<Q", 3) + b"9.9")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="not a rootba problem file"):
            mod.load_rootba(str(bad))
    trailing = tmp_path / "trailing.cereal"
    trailing.write_bytes(open(path, "rb").read() + b"\0")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="trailing bytes"):
            mod.load_rootba(str(trailing))


SKIPS = "\n".join([
    "# Bundle file v0.3", "3 2",
    "100.0 0.0 0.0", "1 0 0  0 1 0  0 0 1", "0 0 0",
    "0.0 0.0 0.0", "1 0 0  0 1 0  0 0 1", "0 0 0",
    "200.0 0.0 0.0", "1 0 0  0 1 0  0 0 1", "1 2 3",
    "1 1 1", "255 0 0", "3  0 7 2.0 3.0   1 8 9.0 9.0   2 9 4.0 5.0",
    "2 2 2", "0 255 0", "1  2 4 6.0 7.0"]) + "\n"
DUPLICATE = "\n".join([
    "# Bundle file v0.3", "1 1",
    "100.0 0.0 0.0", "1 0 0  0 1 0  0 0 1", "0 0 0",
    "1 1 1", "255 0 0", "2  0 7 2.0 3.0   0 8 4.0 5.0"]) + "\n"


def _random_bundler(rng, cams=7, pts=40) -> str:
    """A bundler file with random rotations, two uninitialized cameras
    (f = 0) and views of them, in random view order."""
    lines = ["# Bundle file v0.3", f"{cams} {pts}"]
    for c in range(cams):
        f = 0.0 if c in (2, 5) else 400.0 + 100.0 * rng.random()
        lines.append(f"{f!r} {rng.normal() * 1e-2!r} "
                     f"{rng.normal() * 1e-3!r}")
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        lines.append(" ".join(repr(float(v)) for v in q.reshape(-1)))
        lines.append(" ".join(repr(float(v)) for v in rng.normal(size=3)))
    for _ in range(pts):
        lines.append(" ".join(repr(float(v)) for v in rng.normal(size=3)))
        lines.append("1 2 3")
        views = rng.choice(cams, size=int(rng.integers(1, 5)),
                           replace=False)
        lines.append(f"{len(views)} " + " ".join(
            f"{v} {k} {rng.normal() * 50!r} {rng.normal() * 50!r}"
            for k, v in enumerate(views)))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("case", ["skips", "random", "duplicate"])
def test_load_bundler_equals_jax(tmp_path, case):
    """load_bundler against the JAX package's: the same problem (skipped
    cameras remapped, their views dropped, axis flip), or the same
    rejection of a duplicate view; through the loader's autodetection
    too."""
    text = {"skips": SKIPS, "duplicate": DUPLICATE,
            "random": _random_bundler(np.random.default_rng(3))}[case]
    path = tmp_path / "bundle.out"
    path.write_text(text)
    if case == "duplicate":
        for mod in (TP, JP):
            with pytest.raises(ValueError, match="duplicate observation"):
                mod.load_bundler(str(path), quiet=True)
        return
    t = TP.load_bundler(str(path), quiet=True)
    _same_problem(t, JP.load_bundler(str(path), quiet=True))
    assert t.num_cameras == (2 if case == "skips" else 5)
    if case == "skips":
        np.testing.assert_allclose(t.cam_t[1], [1.0, -2.0, -3.0])
    assert TP.autodetect_input_type(str(path)) == TP.DatasetType.BUNDLER
    _same_problem(TP.load_normalized_bal_problem(TP.BalDatasetOptions(
        input=str(path), quiet=True, normalize=False)),
        JP.load_normalized_bal_problem(JP.BalDatasetOptions(
            input=str(path), quiet=True, normalize=False)))


def test_native_tokenizer(tmp_path, monkeypatch):
    """The native tokenizer builds here and reads the Python tokenizer's
    numbers; load_bal through it equals the JAX package's load_bal; with
    the library unavailable the loader falls back to Python."""
    p = generate_synthetic_bal(num_cams=10, num_lms=150, seed=2)
    path = str(tmp_path / "p.txt")
    write_bal_file(p, path)
    # a last token without a newline takes the tail-copy branch
    with open(tmp_path / "tail.txt", "w") as fp:
        fp.write("1 2.5\t-3e-7\n\n 4.25e+2")
    assert native.available()
    assert native.lib_path().parent.name == "native"
    for f in (path, str(tmp_path / "tail.txt")):
        a, b = native.tokenize_file(f), TP.tokenize_numbers_plain(f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _same_problem(TP.load_bal(path, quiet=True), JP.load_bal(path,
                                                             quiet=True))
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    _same_problem(TP.load_bal(path, quiet=True), JP.load_bal(path,
                                                             quiet=True))
    with pytest.raises(RuntimeError, match="not available"):
        native.tokenize_file(path)


def test_cli_cereal_output_and_input(tmp_path):
    """The CLI writes `.cereal` output (the JAX writer's bytes for the
    solved problem), and a solve from a `.cereal` copy of the input
    gives the solve from the text file's costs bit for bit."""
    from rootba_tpu_torch.cli.bal import run_app

    txt = str(tmp_path / "p.txt")
    write_bal_file(generate_synthetic_bal(num_cams=8, num_lms=120, seed=11),
                   txt)
    cer = str(tmp_path / "p.cereal")
    tio.save_rootba(TP.load_bal(txt, quiet=True), cer)
    logs = {}
    cwd = os.getcwd()
    try:
        for name, inp in (("txt", txt), ("cereal", cer)):
            out = str(tmp_path / f"out_{name}.cereal")
            assert run_app("test", [
                "-C", str(tmp_path), "--input", inp, "--device", "cpu",
                "--max-num-iterations", "3", "--init-depth-threshold",
                "0.1", "--quiet", "--save-output",
                "--output-optimized-path", out]) == 0
            logs[name] = json.loads((tmp_path / "ba_log.json").read_text())
            solved = tio.load_rootba(out, quiet=True)
            jio.save_rootba(solved, str(tmp_path / "again.cereal"))
            assert (open(out, "rb").read()
                    == (tmp_path / "again.cereal").read_bytes())
    finally:
        os.chdir(cwd)
    assert logs["txt"]["cost"] == logs["cereal"]["cost"]
    assert logs["cereal"]["cost"][-1] < logs["cereal"]["cost"][0]


def _write_bundler(p, path):
    """A bundler file of a problem in the loader's convention (the
    inverse of load_bundler's axis flip; rotations from quaternions)."""
    from rootba_tpu_torch.bal import nplie

    flip = np.diag([1.0, -1.0, -1.0])
    lines = ["# Bundle file v0.3", f"{p.num_cameras} {p.num_landmarks}"]
    for c in range(p.num_cameras):
        q = np.broadcast_to(p.cam_q[c], (3, 4))
        R = flip @ nplie.quat_rotate(q, np.eye(3)).T
        lines += [" ".join(repr(float(v)) for v in p.cam_intr[c]),
                  " ".join(repr(float(v)) for v in R.reshape(-1)),
                  " ".join(repr(float(v)) for v in flip @ p.cam_t[c])]
    for m in range(p.num_landmarks):
        k = np.flatnonzero(p.obs_lm == m)
        lines += [" ".join(repr(float(v)) for v in p.lm_p[m]), "0 0 0",
                  f"{len(k)} " + " ".join(
                      f"{p.obs_cam[i]} {i} {float(p.obs_uv[i, 0])!r} "
                      f"{float(-p.obs_uv[i, 1])!r}" for i in k)]
    path.write_text("\n".join(lines) + "\n")


def test_cli_bundler_input(tmp_path):
    """A bundler file solves through the CLI on the CPU (autodetected by
    its name) to the costs of the same problem's BAL text."""
    from rootba_tpu_torch.cli.bal import run_app

    p = generate_synthetic_bal(num_cams=8, num_lms=120, seed=11)
    write_bal_file(p, str(tmp_path / "p.txt"))
    q = TP.load_bal(str(tmp_path / "p.txt"), quiet=True)
    _write_bundler(q, tmp_path / "bundle.out")
    b = TP.load_bundler(str(tmp_path / "bundle.out"), quiet=True)
    np.testing.assert_allclose(b.cam_t, q.cam_t, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.abs(np.sum(b.cam_q * q.cam_q, axis=1)),
                               1.0, rtol=1e-12)
    logs = {}
    cwd = os.getcwd()
    try:
        for name in ("p.txt", "bundle.out"):
            assert run_app("test", [
                "-C", str(tmp_path), "--input", name, "--device", "cpu",
                "--max-num-iterations", "3", "--init-depth-threshold",
                "0.1", "--quiet"]) == 0
            logs[name] = json.loads((tmp_path / "ba_log.json").read_text())
    finally:
        os.chdir(cwd)
    a, b = logs["p.txt"]["cost"], logs["bundle.out"]["cost"]
    assert len(a) == len(b) == 4 and b[-1] < b[0]
    np.testing.assert_allclose(b, a, rtol=1e-9)
