"""Reference-compatible ``.cereal`` binary problem interchange.

The reference saves/loads optimized problems through a cereal
``BinaryOutputArchive`` (reference ``bal/bal_problem_io.hpp:52-83``,
``bal/bal_problem.cpp:137-180``, ``util/serialization.hpp:139-186``).
This module reads and writes that byte layout directly with numpy —
no cereal, no C++ — so ``python -m rootba_tpu_torch.cli.bal --input
problem.cereal`` round-trips with the reference binaries. It is the
port's copy of the JAX package's ``bal/rootba_io.py``: the same bytes
for the same problem.

Byte layout (cereal binary archives are raw little-endian native POD
with NO field names and NO padding; ``size_type`` is ``uint64``):

  file_info                 (util/serialization.hpp:53-61, FileInfo)
    u64 len + bytes         type    = "rootba::BalProblem"
    u64 len + bytes         version = "1.0"
  cameras  (std::vector<Camera>, bal_problem_io.hpp:66-71)
    u64 count
    per camera:
      f64 px, py, pz        SE3 translation      (basalt
      f64 qx, qy, qz, qw    SE3 unit quaternion   headers_serialization
                            in Eigen coeff order  Sophus::SE3 convention)
      f64 f, k1, k2         BalCamera parameter vector
  landmarks  (std::vector<Landmark>, bal_problem_io.hpp:73-78)
    u64 count
    per landmark:
      f64 x, y, z           p_w
      u64 map size          obs (std::map<FrameIdx, Observation>,
      per entry:             cereal map = size + key/value pairs,
        i32 frame index      FrameIdx = int, common_types.hpp:44)
        f64 u, v             Observation.pos

Assumption note: the SE3 field order (translation xyz then quaternion
xyzw) follows basalt's ``headers_serialization.h`` Sophus serializer;
the basalt-headers submodule is not vendored here, so the order is
pinned by ``tests/test_problem.py`` golden bytes (the port's bytes to
the JAX package's by ``tests/test_torch_formats.py``) rather than by a
compiled reference binary.  The archive is NOT self-describing — if a
reference build disagrees, the one free knob is ``_SE3_T_FIRST``.

The repo's native quaternion convention is (w, x, y, z)
(``problem.py`` BalProblem); the conversion happens here.
"""

from __future__ import annotations

import struct

import numpy as np

FILE_TYPE = b"rootba::BalProblem"
FILE_VERSION = b"1.0"

# translation-first SE3 layout (see module docstring)
_SE3_T_FIRST = True

_CAM_DOUBLES = 10  # 3 t + 4 q + 3 intrinsics

# one obs map entry: i32 key + 2 f64, packed (cereal emits no padding)
_OBS_DT = np.dtype([("cam", "<i4"), ("u", "<f8"), ("v", "<f8")],
                   align=False)
assert _OBS_DT.itemsize == 20


def _write_str(parts: list, s: bytes):
    parts.append(struct.pack("<Q", len(s)))
    parts.append(s)


def save_rootba(problem, path: str) -> None:
    """Write ``problem`` in the reference's ``.cereal`` binary layout
    (reference ``BalProblem::save_rootba``, bal_problem.cpp:419-426;
    always double precision, backup variables not serialized)."""
    n_cam = problem.num_cameras
    n_lm = problem.num_landmarks
    n_obs = problem.num_observations

    parts: list = []
    _write_str(parts, FILE_TYPE)
    _write_str(parts, FILE_VERSION)

    # cameras: one [N, 10] f64 block
    cams = np.empty((n_cam, _CAM_DOUBLES), dtype="<f8")
    q_wxyz = np.asarray(problem.cam_q, dtype=np.float64)
    q_xyzw = q_wxyz[:, [1, 2, 3, 0]]
    t = np.asarray(problem.cam_t, dtype=np.float64)
    if _SE3_T_FIRST:
        cams[:, 0:3] = t
        cams[:, 3:7] = q_xyzw
    else:  # pragma: no cover - compat knob
        cams[:, 0:4] = q_xyzw
        cams[:, 4:7] = t
    cams[:, 7:10] = np.asarray(problem.cam_intr, dtype=np.float64)
    parts.append(struct.pack("<Q", n_cam))
    parts.append(cams.tobytes())

    # landmarks: variable-length records assembled by offset arithmetic
    # (obs_lm is sorted/grouped per landmark, problem.py:100-105, and
    # obs_cam ascends within each landmark -- matching std::map's
    # sorted-key iteration order, so the byte stream is canonical)
    counts = np.bincount(problem.obs_lm, minlength=n_lm).astype(np.int64)
    rec_sizes = 24 + 8 + 20 * counts
    lm_starts = np.zeros(n_lm, dtype=np.int64)
    np.cumsum(rec_sizes[:-1], out=lm_starts[1:])
    total = int(lm_starts[-1] + rec_sizes[-1]) if n_lm else 0

    body = np.zeros(total, dtype=np.uint8)
    # p_w + map-size headers via a strided structured view
    hdr = np.empty(n_lm, dtype=np.dtype(
        [("p", "<f8", (3,)), ("n", "<u8")], align=False))
    hdr["p"] = np.asarray(problem.lm_p, dtype=np.float64)
    hdr["n"] = counts.astype(np.uint64)
    hdr_bytes = hdr.view(np.uint8).reshape(n_lm, 32)
    idx = lm_starts[:, None] + np.arange(32)[None, :]
    body[idx.reshape(-1)] = hdr_bytes.reshape(-1)

    # all map entries at once: entry offset = landmark start + 32 +
    # 20 * rank-within-landmark
    obs = np.empty(n_obs, dtype=_OBS_DT)
    obs["cam"] = np.asarray(problem.obs_cam, dtype=np.int32)
    uv = np.asarray(problem.obs_uv, dtype=np.float64)
    obs["u"] = uv[:, 0]
    obs["v"] = uv[:, 1]
    obs_start_of_lm = np.zeros(n_lm, dtype=np.int64)
    np.cumsum(counts[:-1], out=obs_start_of_lm[1:])
    rank = np.arange(n_obs, dtype=np.int64) - obs_start_of_lm[problem.obs_lm]
    e_off = lm_starts[problem.obs_lm] + 32 + 20 * rank
    eidx = e_off[:, None] + np.arange(20)[None, :]
    body[eidx.reshape(-1)] = obs.view(np.uint8).reshape(n_obs, 20).reshape(-1)

    parts.append(struct.pack("<Q", n_lm))
    parts.append(body.tobytes())

    with open(path, "wb") as fp:
        for p in parts:
            fp.write(p)


def load_rootba(path: str, quiet: bool = False):
    """Read a reference ``.cereal`` problem file (reference
    ``BalProblem::load_rootba``, bal_problem.cpp:407-417)."""
    from rootba_tpu_torch.bal.problem import BalProblem

    with open(path, "rb") as fp:
        buf = fp.read()
    mv = memoryview(buf)
    off = 0

    def read_str():
        nonlocal off
        (n,) = struct.unpack_from("<Q", buf, off)
        off += 8
        s = bytes(mv[off:off + n])
        off += n
        return s

    ftype = read_str()
    fversion = read_str()
    if ftype != FILE_TYPE:
        raise ValueError(
            f"not a rootba problem file: type {ftype!r} (expected "
            f"{FILE_TYPE!r})")
    if fversion != FILE_VERSION:
        raise ValueError(
            f"rootba problem file version {fversion!r} != "
            f"{FILE_VERSION!r}")

    (n_cam,) = struct.unpack_from("<Q", buf, off)
    off += 8
    cams = np.frombuffer(buf, dtype="<f8", count=n_cam * _CAM_DOUBLES,
                         offset=off).reshape(n_cam, _CAM_DOUBLES)
    off += n_cam * _CAM_DOUBLES * 8
    if _SE3_T_FIRST:
        t, q_xyzw = cams[:, 0:3], cams[:, 3:7]
    else:  # pragma: no cover - compat knob
        q_xyzw, t = cams[:, 0:4], cams[:, 4:7]
    intr = cams[:, 7:10]
    q_wxyz = q_xyzw[:, [3, 0, 1, 2]]

    (n_lm,) = struct.unpack_from("<Q", buf, off)
    off += 8

    # sequential scan: record i's length depends on its map size, so
    # walk the headers once (cheap: one u64 read per landmark), then
    # bulk-extract every field vectorized
    counts = np.empty(n_lm, dtype=np.int64)
    lm_starts = np.empty(n_lm, dtype=np.int64)
    pos = off
    u64 = struct.Struct("<Q")
    for i in range(n_lm):
        lm_starts[i] = pos
        (k,) = u64.unpack_from(buf, pos + 24)
        counts[i] = k
        pos += 32 + 20 * k
    if pos != len(buf):
        raise ValueError(
            f"trailing bytes in {path}: consumed {pos} of {len(buf)}")

    body = np.frombuffer(buf, dtype=np.uint8)
    pidx = lm_starts[:, None] + np.arange(24)[None, :]
    lm_p = body[pidx.reshape(-1)].reshape(n_lm, 24).copy().view(
        "<f8").reshape(n_lm, 3)

    n_obs = int(counts.sum())
    obs_lm = np.repeat(np.arange(n_lm, dtype=np.int64), counts)
    obs_start_of_lm = np.zeros(n_lm, dtype=np.int64)
    np.cumsum(counts[:-1], out=obs_start_of_lm[1:])
    rank = np.arange(n_obs, dtype=np.int64) - obs_start_of_lm[obs_lm]
    e_off = lm_starts[obs_lm] + 32 + 20 * rank
    eidx = e_off[:, None] + np.arange(20)[None, :]
    recs = body[eidx.reshape(-1)].reshape(n_obs, 20).copy().view(_OBS_DT)
    recs = recs.reshape(n_obs)

    obs_uv = np.empty((n_obs, 2), dtype=np.float64)
    obs_uv[:, 0] = recs["u"]
    obs_uv[:, 1] = recs["v"]

    p = BalProblem(
        cam_q=np.ascontiguousarray(q_wxyz),
        cam_t=np.ascontiguousarray(t),
        cam_intr=np.ascontiguousarray(intr),
        lm_p=np.ascontiguousarray(lm_p),
        obs_lm=obs_lm,
        obs_cam=recs["cam"].astype(np.int64),
        obs_uv=obs_uv,
        quiet=quiet,
    )
    # std::map iteration is key-sorted, so obs arrive grouped by lm
    # with ascending cam -- already this repo's canonical order; sort
    # defensively anyway (cheap, idempotent)
    p.sort_observations()
    return p
