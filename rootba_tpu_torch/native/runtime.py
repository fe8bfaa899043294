"""ctypes binding of the native (C++) host runtime: the BAL tokenizer.

The reference parses BAL text with C++; a Python split of 9M
observations' text takes minutes. `src/host_runtime.cpp` (a copy of the
JAX package's `native/src/host_runtime.cpp`) holds an mmap-based
tokenizer behind a C interface, `rootba_count_tokens` and
`rootba_tokenize_file`.

It is built with g++ at first use, from the source in this package
(the JAX package's Makefile flags), into `build/native/` at the
repository root (listed in .gitignore), named by a hash of the source
and the flags so that an edited source is rebuilt. This is host
parsing, not a device kernel: without a compiler, or with
ROOTBA_NO_NATIVE_BUILD set, `available()` is False and the loader
falls back to the Python tokenizer (bal/problem.py), as the JAX
package does. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "host_runtime.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-Wextra", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> Path:
    tag = hashlib.sha1(_SRC.read_bytes()
                       + " ".join(CXXFLAGS).encode()).hexdigest()
    return _BUILD / f"librootba_host-{tag[:12]}.so"


def _try_build(path: Path) -> None:
    """Best-effort g++ build of the shared library (a build artifact,
    not checked in). Disable with ROOTBA_NO_NATIVE_BUILD=1."""
    if os.environ.get("ROOTBA_NO_NATIVE_BUILD"):
        return
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(_SRC)],
                           timeout=120, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        if r.returncode == 0:
            os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired):
        pass
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = lib_path()
    if not path.exists():
        _try_build(path)
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.rootba_count_tokens.restype = ctypes.c_longlong
    lib.rootba_count_tokens.argtypes = [ctypes.c_char_p]
    lib.rootba_tokenize_file.restype = ctypes.c_longlong
    lib.rootba_tokenize_file.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native library is built (building it on first call)
    and loaded."""
    return _load() is not None


def tokenize_file(path: str) -> np.ndarray:
    """All whitespace-separated numeric tokens of a file, as float64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    n = lib.rootba_count_tokens(path.encode())
    if n < 0:
        raise IOError(f"could not read '{path}'")
    out = np.empty(int(n), dtype=np.float64)
    got = lib.rootba_tokenize_file(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.size,
    )
    if got < 0:
        raise IOError(f"could not parse '{path}'")
    return out[: int(got)]
