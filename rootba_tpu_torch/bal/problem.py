"""BAL problem state, dataset IO and the preprocessing pipeline.

Host-side struct-of-arrays container (numpy, float64) re-designing the
reference's AoS ``BalProblem<Scalar>`` (src/rootba/bal/bal_problem.hpp:61-236)
for batched device upload: cameras as (quat, trans, intrinsics) arrays,
landmarks as one position array, observations as flat (lm, cam, uv)
arrays sorted by (lm, cam) — the same ordering as the reference's
per-landmark std::map<FrameIdx, obs>.

Pipeline semantics mirror load_normalized_bal_problem
(bal_problem.cpp:774-853): load as double -> normalize (median/MAD) ->
perturb (bit-exact libstdc++ RNG, see rootba_tpu_torch.bal.rng) -> filter by
depth -> cast to solver dtype at bucketing time.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rootba_tpu_torch.bal import nplie
from rootba_tpu_torch.bal.rng import MinstdRand0, perturbation
from rootba_tpu_torch.config.options import BalDatasetOptions, DatasetType
from rootba_tpu_torch.log import trace

CAM_STATE_SIZE = 10  # quaternion(4) + translation(3) + intrinsics(3)
POSE_SIZE = 9  # tangent: trans(3) + rot(3) + intrinsics(3)


@dataclass
class DatasetSummary:
    """Reference: bal_pipeline_summary.hpp:42-79."""

    input_path: str = ""
    type: str = "bal"
    num_cameras: int = 0
    num_landmarks: int = 0
    num_observations: int = 0
    per_lm_obs_mean: float = 0.0
    per_lm_obs_stddev: float = 0.0
    per_lm_obs_min: int = 0
    per_lm_obs_max: int = 0


@dataclass
class PipelineTimingSummary:
    load_time: float = 0.0
    preprocess_time: float = 0.0
    optimize_time: float = 0.0
    postprocess_time: float = 0.0


@dataclass
class BalProblem:
    """Bundle adjustment problem state (always float64 on host).

    cam_q:   [N,4] world-to-cam unit quaternion (w,x,y,z)
    cam_t:   [N,3] world-to-cam translation
    cam_intr:[N,3] (f, k1, k2)
    lm_p:    [M,3] landmark positions (world)
    obs_lm:  [O]   landmark index per observation (sorted, grouped by lm)
    obs_cam: [O]   camera index per observation (ascending within each lm)
    obs_uv:  [O,2] observed pixel position (axis-flipped convention)
    """

    cam_q: np.ndarray
    cam_t: np.ndarray
    cam_intr: np.ndarray
    lm_p: np.ndarray
    obs_lm: np.ndarray
    obs_cam: np.ndarray
    obs_uv: np.ndarray
    quiet: bool = False

    # ------------------------------------------------------------------
    @property
    def num_cameras(self) -> int:
        return self.cam_q.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.lm_p.shape[0]

    @property
    def num_observations(self) -> int:
        return self.obs_lm.shape[0]

    def copy(self) -> "BalProblem":
        return BalProblem(
            self.cam_q.copy(), self.cam_t.copy(), self.cam_intr.copy(),
            self.lm_p.copy(), self.obs_lm.copy(), self.obs_cam.copy(),
            self.obs_uv.copy(), self.quiet,
        )

    # ------------------------------------------------------------------
    def sort_observations(self):
        """Group obs by landmark, ascending camera within each group."""
        order = np.lexsort((self.obs_cam, self.obs_lm))
        self.obs_lm = np.ascontiguousarray(self.obs_lm[order])
        self.obs_cam = np.ascontiguousarray(self.obs_cam[order])
        self.obs_uv = np.ascontiguousarray(self.obs_uv[order])

    def obs_per_landmark(self) -> np.ndarray:
        return np.bincount(self.obs_lm, minlength=self.num_landmarks)

    # ------------------------------------------------------------------
    # preprocessing (reference bal_problem.cpp:429-554)
    # ------------------------------------------------------------------
    def normalize(self, new_scale: float = 100.0):
        """Median-center, scale so that median absolute deviation (L1)
        equals new_scale. Reference bal_problem.cpp:429-470 (median via
        nth_element at index n/2 = upper median)."""
        n = self.num_landmarks
        k = n // 2
        median = np.partition(self.lm_p, k, axis=0)[k]
        dev = np.sum(np.abs(self.lm_p - median), axis=1)
        mad = np.partition(dev, k)[k]
        scale = new_scale / mad
        if not self.quiet:
            print(f"Normalizing BAL problem (median: {median}, MAD: {mad}, "
                  f"scale: {scale})")
        self.lm_p = scale * (self.lm_p - median)
        # cameras: center = scale * (center - median), center = -R^T t
        qinv = nplie.quat_conj(self.cam_q)
        center = nplie.quat_rotate(qinv, -self.cam_t)
        center = scale * (center - median)
        self.cam_t = -nplie.quat_rotate(self.cam_q, center)

    def perturb(self, rotation_sigma: float, translation_sigma: float,
                point_sigma: float, seed: int):
        """Gaussian state perturbation, draw-order identical to reference
        bal_problem.cpp:509-554 (cameras first: translation then rotation
        per camera; then landmarks)."""
        if rotation_sigma < 0 or translation_sigma < 0 or point_sigma < 0:
            raise ValueError("sigmas must be non-negative")
        if rotation_sigma == 0 and translation_sigma == 0 and point_sigma == 0:
            return
        if not self.quiet:
            print(f"Perturbing state (seed: {seed}): R: {rotation_sigma}, "
                  f"t: {translation_sigma}, p: {point_sigma}")
        eng = MinstdRand0(seed if seed >= 0
                          else int.from_bytes(os.urandom(4), "little"))
        if rotation_sigma > 0 or translation_sigma > 0:
            for i in range(self.num_cameras):
                if translation_sigma > 0:
                    # perturb camera center in world coordinates
                    qinv = nplie.quat_conj(self.cam_q[i])
                    center = nplie.quat_rotate(qinv, -self.cam_t[i])
                    center = center + perturbation(translation_sigma, eng)
                    self.cam_t[i] = -nplie.quat_rotate(self.cam_q[i], center)
                if rotation_sigma > 0:
                    dq = nplie.so3_exp(perturbation(rotation_sigma, eng))
                    self.cam_q[i] = nplie.quat_normalize(
                        nplie.quat_mul(dq, self.cam_q[i]))
        if point_sigma > 0:
            for i in range(self.num_landmarks):
                self.lm_p[i] += perturbation(point_sigma, eng)

    def filter_obs(self, threshold: float):
        """Drop observations with camera-frame depth < threshold, then
        landmarks with < 2 remaining observations (renumbering).
        Reference bal_problem.cpp:472-506."""
        if threshold <= 0:
            return
        if not self.quiet:
            print(f"Filtering observations with z < {threshold}")
        p_c = (nplie.quat_rotate(self.cam_q[self.obs_cam],
                                 self.lm_p[self.obs_lm])
               + self.cam_t[self.obs_cam])
        keep = p_c[:, 2] >= threshold
        self.obs_lm = self.obs_lm[keep]
        self.obs_cam = self.obs_cam[keep]
        self.obs_uv = self.obs_uv[keep]
        counts = np.bincount(self.obs_lm, minlength=self.num_landmarks)
        keep_lm = counts >= 2
        new_idx = np.cumsum(keep_lm) - 1
        keep_obs = keep_lm[self.obs_lm]
        self.obs_lm = new_idx[self.obs_lm[keep_obs]]
        self.obs_cam = self.obs_cam[keep_obs]
        self.obs_uv = self.obs_uv[keep_obs]
        self.lm_p = self.lm_p[keep_lm]

    # ------------------------------------------------------------------
    def summarize(self, input_path: str = "") -> DatasetSummary:
        counts = self.obs_per_landmark()
        return DatasetSummary(
            input_path=input_path,
            num_cameras=self.num_cameras,
            num_landmarks=self.num_landmarks,
            num_observations=self.num_observations,
            per_lm_obs_mean=float(counts.mean()) if counts.size else 0.0,
            per_lm_obs_stddev=float(counts.std()) if counts.size else 0.0,
            per_lm_obs_min=int(counts.min()) if counts.size else 0,
            per_lm_obs_max=int(counts.max()) if counts.size else 0,
        )

    def stats_str(self) -> str:
        s = self.summarize()
        return (f"BAL problem stats: {s.num_cameras} cams, "
                f"{s.num_landmarks} lms, {s.num_observations} obs, "
                f"per-lm-obs: {s.per_lm_obs_mean:.1f}+-"
                f"{s.per_lm_obs_stddev:.1f}/{s.per_lm_obs_min}/"
                f"{s.per_lm_obs_max}")

    # ------------------------------------------------------------------
    def save_npz(self, path: str):
        """rootba-binary-format equivalent (npz instead of cereal)."""
        np.savez_compressed(
            path, cam_q=self.cam_q, cam_t=self.cam_t,
            cam_intr=self.cam_intr, lm_p=self.lm_p, obs_lm=self.obs_lm,
            obs_cam=self.obs_cam, obs_uv=self.obs_uv)

    @staticmethod
    def load_npz(path: str) -> "BalProblem":
        z = np.load(path)
        return BalProblem(
            z["cam_q"], z["cam_t"], z["cam_intr"], z["lm_p"],
            z["obs_lm"], z["obs_cam"], z["obs_uv"])

    def save_bal(self, path: str):
        """Write the problem in BAL text format, undoing the loader's
        axis-flip convention (load_bal / reference bal_problem.cpp:
        190-283: obs y negated, camera frame rotated by diag(1,-1,-1))
        so the output is readable by the reference and any other BAL
        consumer."""
        flip_q = np.array([0.0, 1.0, 0.0, 0.0])  # 180deg about x; self-inverse
        q_raw = nplie.quat_mul(
            np.broadcast_to(flip_q, (self.num_cameras, 4)), self.cam_q)
        rod = nplie.so3_log(q_raw)
        t_raw = self.cam_t @ _AXIS_FLIP.T
        lines = [f"{self.num_cameras} {self.num_landmarks} "
                 f"{self.num_observations}"]
        uv = self.obs_uv
        for k in range(self.num_observations):
            lines.append(f"{self.obs_cam[k]} {self.obs_lm[k]} "
                         f"{uv[k, 0]:.16e} {-uv[k, 1]:.16e}")
        for c in range(self.num_cameras):
            for v in (*rod[c], *t_raw[c], *self.cam_intr[c]):
                lines.append(f"{v:.16e}")
        for m in range(self.num_landmarks):
            for v in self.lm_p[m]:
                lines.append(f"{v:.16e}")
        with open(path, "w") as fp:
            fp.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

_AXIS_FLIP = np.diag([1.0, -1.0, -1.0])


def tokenize_numbers_plain(path: str) -> np.ndarray:
    """Whitespace-separated numeric tokens of a text file as float64, in
    Python (the native tokenizer's plain version and fallback)."""
    with open(path, "rb") as fp:
        data = fp.read()
    return np.array(data.split(), dtype=np.float64)


def _tokenize_numbers(path: str) -> np.ndarray:
    """Whitespace-separated numeric tokens of a text file as float64:
    the native tokenizer (native/runtime.py) when it is available."""
    from rootba_tpu_torch.native import runtime as native

    if native.available():
        return native.tokenize_file(path)
    return tokenize_numbers_plain(path)


def load_bal(path: str, quiet: bool = False) -> BalProblem:
    """Parse BAL text format with the reference's axis-flip convention
    (bal_problem.cpp:190-283): obs y negated; camera frame rotated by
    diag(1,-1,-1) so positive z looks forward."""
    tok = _tokenize_numbers(path)
    num_cams, num_lms, num_obs = (int(tok[0]), int(tok[1]), int(tok[2]))
    if num_cams <= 0 or num_lms <= 0 or num_obs <= 0:
        raise ValueError(f"invalid BAL header in {path}")
    p = 3
    obs = tok[p:p + 4 * num_obs].reshape(num_obs, 4)
    p += 4 * num_obs
    cams = tok[p:p + 9 * num_cams].reshape(num_cams, 9)
    p += 9 * num_cams
    pts = tok[p:p + 3 * num_lms].reshape(num_lms, 3)

    obs_cam = obs[:, 0].astype(np.int64)
    obs_lm = obs[:, 1].astype(np.int64)
    if (obs_cam.min(initial=0) < 0 or obs_cam.max(initial=-1) >= num_cams
            or obs_lm.min(initial=0) < 0
            or obs_lm.max(initial=-1) >= num_lms):
        raise ValueError(f"observation index out of range in {path}")
    # the reference rejects duplicate (lm, cam) observations
    # (bal_problem.cpp:230-231 try_emplace CHECK(inserted))
    pair_keys = obs_lm * num_cams + obs_cam
    if len(np.unique(pair_keys)) != len(pair_keys):
        raise ValueError(f"Invalid file '{path}': duplicate observation")
    obs_uv = obs[:, 2:4].copy()
    obs_uv[:, 1] = -obs_uv[:, 1]  # invert y axis

    # camera: R = diag(1,-1,-1) @ exp(rodrigues); t = diag(1,-1,-1) @ t_raw
    q_rod = nplie.so3_exp(cams[:, 0:3])
    flip_q = np.array([0.0, 1.0, 0.0, 0.0])  # 180deg about x = diag(1,-1,-1)
    cam_q = nplie.quat_normalize(
        nplie.quat_mul(np.broadcast_to(flip_q, (num_cams, 4)), q_rod))
    cam_t = cams[:, 3:6] @ _AXIS_FLIP.T
    cam_intr = cams[:, 6:9].copy()

    problem = BalProblem(cam_q, cam_t, cam_intr, pts.copy(), obs_lm, obs_cam,
                         obs_uv, quiet)
    problem.sort_observations()
    if not quiet:
        print(f"Loaded BAL problem ({num_cams} cams, {num_lms} lms, "
              f"{num_obs} obs) from '{path}'")
    return problem


def load_bundler(path: str, quiet: bool = False) -> BalProblem:
    """Parse bundler format (reference bal_problem.cpp:285-404): header
    '# Bundle file v0.3' comment, then num_cams num_pts; per camera
    f k1 k2, R (9), t (3); per point: pos(3), color(3), view list
    (cam, key, x, y)."""
    with open(path, "r") as fp:
        lines = fp.readlines()
    i = 0
    while lines[i].lstrip().startswith("#"):
        i += 1
    tok_iter = iter(" ".join(lines[i:]).split())

    def nxt():
        return next(tok_iter)

    num_cams = int(nxt())
    num_pts = int(nxt())
    cam_q_l, cam_t_l, cam_intr_l = [], [], []
    # cameras with focal length 0 are uninitialized: the reference
    # skips them and remaps indices (bal_problem.cpp:321-339), then
    # drops observations that reference a skipped camera (:372-375)
    cam_idx_mapping = {}
    for c in range(num_cams):
        intr = [float(nxt()), float(nxt()), float(nxt())]
        R = np.array([float(nxt()) for _ in range(9)]).reshape(3, 3)
        t = np.array([float(nxt()) for _ in range(3)])
        if intr[0] == 0:
            continue
        cam_idx_mapping[c] = len(cam_q_l)
        R = _AXIS_FLIP @ R
        t = _AXIS_FLIP @ t
        cam_q_l.append(nplie.quat_from_matrix(R))
        cam_t_l.append(t)
        cam_intr_l.append(intr)
    cam_q = np.asarray(cam_q_l).reshape(-1, 4)
    cam_t = np.asarray(cam_t_l).reshape(-1, 3)
    cam_intr = np.asarray(cam_intr_l).reshape(-1, 3)
    lm_p = np.zeros((num_pts, 3))
    obs_lm_l, obs_cam_l, obs_uv_l = [], [], []
    for m in range(num_pts):
        lm_p[m] = [float(nxt()), float(nxt()), float(nxt())]
        _ = [nxt() for _ in range(3)]  # color
        nviews = int(nxt())
        seen = set()
        for _ in range(nviews):
            cam = int(nxt())
            _key = nxt()
            x = float(nxt())
            y = float(nxt())
            if cam not in cam_idx_mapping:
                continue  # observation of a skipped camera
            if cam in seen:
                # reference try_emplace CHECK(inserted),
                # bal_problem.cpp:376-379
                raise ValueError(
                    f"Invalid file '{path}': duplicate observation")
            seen.add(cam)
            obs_lm_l.append(m)
            obs_cam_l.append(cam_idx_mapping[cam])
            obs_uv_l.append((x, -y))
    problem = BalProblem(
        cam_q, cam_t, cam_intr, lm_p,
        np.array(obs_lm_l, dtype=np.int64),
        np.array(obs_cam_l, dtype=np.int64),
        np.array(obs_uv_l, dtype=np.float64), quiet)
    problem.sort_observations()
    if not quiet:
        print(f"Loaded bundler problem ({num_cams} cams, {num_pts} lms, "
              f"{problem.num_observations} obs) from '{path}'")
    return problem


def autodetect_input_type(path: str) -> DatasetType:
    """Reference bal_problem.cpp:124-135 (with npz standing in for the
    cereal-based 'rootba' binary format)."""
    name = os.path.basename(path)
    if name.endswith(".cereal") or name.endswith(".npz"):
        return DatasetType.ROOTBA
    if "bundle" in name:
        return DatasetType.BUNDLER
    return DatasetType.BAL


def load_normalized_bal_problem(
    options_or_path,
    dataset_summary: Optional[DatasetSummary] = None,
    timing_summary: Optional[PipelineTimingSummary] = None,
) -> BalProblem:
    """Full preprocessing pipeline (reference bal_problem.cpp:774-853).
    Its steps are the spans load.parse, load.normalize, load.perturb and
    load.filter of log/trace.py, from the timestamps that timing_summary
    gets too."""
    if isinstance(options_or_path, str):
        options = BalDatasetOptions(input=options_or_path)
    else:
        options = options_or_path

    t0 = time.monotonic()
    input_type = options.input_type
    if input_type == DatasetType.AUTO:
        input_type = autodetect_input_type(options.input)
        if not options.quiet:
            print(f"Autodetected input dataset type as {input_type}.")

    if input_type == DatasetType.ROOTBA:
        if options.input.endswith(".cereal"):
            # reference cereal binary (bal_problem.cpp:407-417)
            from rootba_tpu_torch.bal.rootba_io import load_rootba

            problem = load_rootba(options.input, quiet=options.quiet)
        else:
            problem = BalProblem.load_npz(options.input)
            problem.quiet = options.quiet
    elif input_type == DatasetType.BAL:
        problem = load_bal(options.input, options.quiet)
    elif input_type == DatasetType.BUNDLER:
        problem = load_bundler(options.input, options.quiet)
    else:
        raise ValueError(f"unknown input type {input_type}")
    t1 = time.monotonic()
    trace.add("load.parse", t0, t1)

    t = t1
    if options.normalize:
        problem.normalize(options.normalization_scale)
        t = trace.since("load.normalize", t)
    problem.perturb(options.rotation_sigma, options.translation_sigma,
                    options.point_sigma, options.random_seed)
    t = trace.since("load.perturb", t)
    problem.filter_obs(options.init_depth_threshold)
    t2 = time.monotonic()
    trace.add("load.filter", t, t2)
    t_load = t1 - t0
    t_preprocess = t2 - t1

    if timing_summary is not None:
        timing_summary.load_time = t_load
        timing_summary.preprocess_time = t_preprocess
    if dataset_summary is not None:
        s = problem.summarize(options.input)
        for f in dataclasses.fields(s):
            setattr(dataset_summary, f.name, getattr(s, f.name))
    if not options.quiet:
        print(problem.stats_str())
    return problem


def load_normalized_bal_problem_quiet(path: str) -> BalProblem:
    return load_normalized_bal_problem(
        BalDatasetOptions(input=path, quiet=True))
