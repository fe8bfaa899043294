"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface (for sm_90a, the H100) and loaded with ctypes. A
build happens at first use, or up front through `build_all()`, which
starts one nvcc per source at once. Libraries go to `build/kernels/` at
the repository root (listed in .gitignore), named by a hash of the
source and the flags so that an edited source is rebuilt.

Tensors pass as raw pointers (`data_ptr()`), the stream as
`torch.cuda.current_stream().cuda_stream`; every C entry returns the
CUDA error code, which `check()` turns into an exception.

Importing this module touches neither nvcc nor the card: the CPU tests
import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fold", "w_build", "cg_dense")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# (name -> loaded library): a loaded shared object is a process-wide
# resource, loaded once and kept for the life of the process
_LIBS: Dict[str, ctypes.CDLL] = {}

# kernel launches per wrapper: each wrapper adds one where it launches
# its kernel, and nowhere else (its plain CPU path does not count), so
# a run can show that its path went through the kernels
LAUNCHES: Dict[str, int] = {"outer81_fold": 0, "w_build": 0,
                            "pcg_dense_cluster": 0, "pcg_dense_half": 0,
                            "pcg_dense_grid": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of every entry (argtypes); all return int (cudaError_t)
_SIGNATURES = {
    "fold": {
        "rb_outer81_fold_f32": (_P, _P, _P, _LL, _I, _I, _P),
        "rb_outer81_fold_f64": (_P, _P, _P, _LL, _I, _I, _P),
    },
    "w_build": {
        "rb_w_build_f32": (_P, _P, _P, _LL, _P),
        "rb_w_build_f64": (_P, _P, _P, _LL, _P),
    },
    "cg_dense": {
        "rb_pcg_dense_f32": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                             _F, _F, _I, _P),
        "rb_pcg_dense_grid_plan": (_I, _I, _P, _P),
        "rb_pcg_dense_cluster_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _F, _F, _I, _P),
        "rb_pcg_dense_half_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                  _F, _I, _P),
        "rb_pcg_dense_cluster_plan": (_I, _P, _P),
    },
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD / f"lib{name}-{tag[:12]}.so"


def build_all(names: Iterable[str] = SOURCES,
              verbose: bool = False) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc
    process per source, all started at once; raises with the compiler's
    output if one fails. Returns the library paths. verbose adds
    `-Xptxas -v` (registers, shared memory, spills per kernel) and
    prints the compiler's output."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose
                                      else []),
               "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        if verbose and out:
            print(f"[nvcc {n}.cu]\n{out}", flush=True)
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as an integer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
