"""BA log loading (port of the reference python/rootba/log.py concepts).

Loads ba_log.json / ba_log.ubjson into a simple attribute-access object
with numpy arrays for the per-iteration columns and nested structures
for the `_static` blob.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np


class Attrs(dict):
    """Dict with attribute access (stand-in for Munch)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError:
            raise AttributeError(k) from None
        return v

    __setattr__ = dict.__setitem__


def _wrap(obj):
    if isinstance(obj, dict):
        return Attrs({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        if obj and all(isinstance(x, (int, float, bool)) for x in obj):
            return np.asarray(obj)
        return [_wrap(x) for x in obj]
    return obj


def _parse_ubjson(data: bytes):
    """Decoder for the UBJSON subset written by the port's log writer
    (rootba_tpu_torch.log.ba_log) and nlohmann::json (no optimized
    containers with $ types needed for our own logs; nlohmann may emit
    count-optimized containers '#')."""
    pos = 0

    def need(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated ubjson")

    def parse_value(marker=None):
        nonlocal pos
        if marker is None:
            marker = data[pos:pos + 1]
            pos += 1
        if marker == b"Z":
            return None
        if marker == b"T":
            return True
        if marker == b"F":
            return False
        if marker == b"i":
            need(1); v = struct.unpack_from(">b", data, pos)[0]; pos += 1
            return v
        if marker == b"U":
            need(1); v = struct.unpack_from(">B", data, pos)[0]; pos += 1
            return v
        if marker == b"I":
            need(2); v = struct.unpack_from(">h", data, pos)[0]; pos += 2
            return v
        if marker == b"l":
            need(4); v = struct.unpack_from(">i", data, pos)[0]; pos += 4
            return v
        if marker == b"L":
            need(8); v = struct.unpack_from(">q", data, pos)[0]; pos += 8
            return v
        if marker == b"d":
            need(4); v = struct.unpack_from(">f", data, pos)[0]; pos += 4
            return v
        if marker == b"D":
            need(8); v = struct.unpack_from(">d", data, pos)[0]; pos += 8
            return v
        if marker == b"S":
            n = parse_value()
            need(n)
            v = data[pos:pos + n].decode()
            pos2 = pos + n
            set_pos(pos2)
            return v
        if marker == b"[":
            return parse_container(b"]")
        if marker == b"{":
            return parse_object()
        raise ValueError(f"unknown ubjson marker {marker!r} at {pos}")

    def set_pos(p):
        nonlocal pos
        pos = p

    def parse_container(end):
        nonlocal pos
        out = []
        elem_type = None
        count = None
        if data[pos:pos + 1] == b"$":
            pos += 1
            elem_type = data[pos:pos + 1]
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos += 1
            count = parse_value()
        if count is not None:
            for _ in range(count):
                out.append(parse_value(elem_type))
            return out
        while data[pos:pos + 1] != end:
            out.append(parse_value())
        pos += 1
        return out

    def parse_object():
        nonlocal pos
        out = {}
        elem_type = None
        count = None
        if data[pos:pos + 1] == b"$":
            pos += 1
            elem_type = data[pos:pos + 1]
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos += 1
            count = parse_value()
        n_read = 0
        while True:
            if count is not None and n_read >= count:
                break
            if count is None and data[pos:pos + 1] == b"}":
                pos += 1
                break
            klen = parse_value()
            need(klen)
            key = data[pos:pos + klen].decode()
            set_pos(pos + klen)
            out[key] = parse_value(elem_type)
            n_read += 1
        return out

    return parse_value()


def load_ba_log(path: str) -> Attrs:
    """Load a ba_log.json or .ubjson file. Returns an attribute-dict
    with ._static and numpy-array per-iteration columns."""
    if path.endswith(".ubjson"):
        with open(path, "rb") as fp:
            raw = _parse_ubjson(fp.read())
    else:
        with open(path) as fp:
            raw = json.load(fp)
    if raw.get("_type") != "rootba":
        raise ValueError(f"{path}: not a rootba log")
    return _wrap(raw)


def find_log(dirpath: str) -> str:
    for name in ("ba_log.ubjson", "ba_log.json"):
        p = os.path.join(dirpath, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no ba_log in {dirpath}")
