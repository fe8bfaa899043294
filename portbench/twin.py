"""Seeded BAL twins and their BAL text file, frozen for the benchmark.

A frozen copy of the port's twin generator (`generate_synthetic_bal`
with structure "clustered", and the landmark filter and observation
sort it ends with) and of its BAL text writer, so that a change to the
program's generator cannot move the benchmark's inputs. Cameras sit on
a noisy ring looking inward at a clustered point cloud; track lengths
are log-normal and each landmark is seen from a window of the ring (the
covisibility knobs of a configuration file: track_sigma,
window_stretch, p_far, max_window_frac); observations are exact
projections plus pixel noise. The file is written in the original BAL
convention (negative-z forward, y-up), every float as "%.17g", so that
loading it gives back the twin's values exactly.

The twin is a dict of numpy arrays in the internal convention
(positive-z forward, y-down): cam_q [N,4] (w,x,y,z), cam_t [N,3],
cam_intr [N,3] (f,k1,k2), lm_p [M,3], obs_lm [O], obs_cam [O] (sorted
by landmark, then camera), obs_uv [O,2].
"""

from __future__ import annotations

import numpy as np


def _quat_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_rotate(q, v):
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_from_matrix(R):
    """Rotation matrices [...,3,3] -> unit quaternions (Shepperd)."""
    R = np.asarray(R, dtype=np.float64)
    batch = R.shape[:-2]
    t = np.trace(R, axis1=-2, axis2=-1)
    c0 = t > 0
    s = np.sqrt(np.where(c0, t + 1.0, 1.0)) * 2.0
    q0 = np.stack([0.25 * s,
                   (R[..., 2, 1] - R[..., 1, 2]) / s,
                   (R[..., 0, 2] - R[..., 2, 0]) / s,
                   (R[..., 1, 0] - R[..., 0, 1]) / s], axis=-1)

    def case(i, j, k):
        s = np.sqrt(np.maximum(
            1.0 + R[..., i, i] - R[..., j, j] - R[..., k, k], 0.0)) * 2.0
        s = np.where(s == 0, 1.0, s)
        out = np.zeros(batch + (4,), dtype=np.float64)
        out[..., 0] = (R[..., k, j] - R[..., j, k]) / s
        out[..., 1 + i] = 0.25 * s
        out[..., 1 + j] = (R[..., j, i] + R[..., i, j]) / s
        out[..., 1 + k] = (R[..., k, i] + R[..., i, k]) / s
        return out

    c1 = (R[..., 0, 0] >= R[..., 1, 1]) & (R[..., 0, 0] >= R[..., 2, 2])
    c2 = R[..., 1, 1] >= R[..., 2, 2]
    q = np.where(c0[..., None], q0,
                 np.where(c1[..., None], case(0, 1, 2),
                          np.where(c2[..., None], case(1, 2, 0),
                                   case(2, 0, 1))))
    return _quat_normalize(q)


def generate(num_cams: int, num_lms: int, num_obs: int, seed: int,
             track_sigma: float, window_stretch: float, p_far: float,
             max_window_frac: float, pixel_noise: float = 1.0,
             radius: float = 10.0, focal: float = 800.0) -> dict:
    """The twin of a BAL problem of num_cams cameras, num_lms landmarks
    and about num_obs observations, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    mean_obs_per_lm = num_obs / num_lms

    angles = np.linspace(0, 2 * np.pi, num_cams, endpoint=False)
    centers = np.stack([radius * np.cos(angles), radius * np.sin(angles),
                        rng.normal(0, 0.5, num_cams)], axis=1)
    centers += rng.normal(0, 0.3, centers.shape)
    fwd = -centers
    fwd /= np.linalg.norm(fwd, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (num_cams, 1))
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    cam_q = _quat_from_matrix(R)
    cam_t = -np.einsum("nij,nj->ni", R, centers)
    cam_intr = np.stack([focal * rng.uniform(0.9, 1.1, num_cams),
                         rng.uniform(-1e-7, -1e-8, num_cams),
                         rng.uniform(1e-14, 1e-13, num_cams)], axis=1)
    lm_p = rng.normal(0, 2.0, (num_lms, 3))

    obs_lm, obs_cam = _clustered_observations(
        rng, num_cams, num_lms, mean_obs_per_lm, track_sigma,
        window_stretch, p_far, max_window_frac)

    p_c = _quat_rotate(cam_q[obs_cam], lm_p[obs_lm]) + cam_t[obs_cam]
    keep = p_c[:, 2] >= 0.5
    obs_lm, obs_cam, p_c = obs_lm[keep], obs_cam[keep], p_c[keep]
    d = p_c[:, :2] / p_c[:, 2:3]
    r2 = np.sum(d * d, axis=1)
    f = cam_intr[obs_cam, 0]
    k1 = cam_intr[obs_cam, 1]
    k2 = cam_intr[obs_cam, 2]
    obs_uv = ((f * (1 + k1 * r2 + k2 * r2 * r2))[:, None] * d
              + rng.normal(0, pixel_noise, (obs_lm.size, 2)))
    obs_cam = obs_cam.astype(np.int64)

    # landmarks left with fewer than 2 observations go, renumbered
    counts = np.bincount(obs_lm, minlength=num_lms)
    keep_lm = counts >= 2
    new_idx = np.cumsum(keep_lm) - 1
    keep_obs = keep_lm[obs_lm]
    obs_lm = new_idx[obs_lm[keep_obs]]
    obs_cam = obs_cam[keep_obs]
    obs_uv = obs_uv[keep_obs]
    lm_p = lm_p[keep_lm]
    order = np.lexsort((obs_cam, obs_lm))
    return dict(cam_q=cam_q, cam_t=cam_t, cam_intr=cam_intr, lm_p=lm_p,
                obs_lm=np.ascontiguousarray(obs_lm[order]),
                obs_cam=np.ascontiguousarray(obs_cam[order]),
                obs_uv=np.ascontiguousarray(obs_uv[order]))


def _clustered_observations(rng, num_cams, num_lms, mean_obs_per_lm,
                            track_sigma, window_stretch, p_far,
                            max_window_frac):
    """(obs_lm, obs_cam): log-normal track lengths, each landmark's
    cameras drawn without repeats from a heavy-tailed window of the
    ring, a p_far share moved to a second arc, duplicates dropped."""
    z = np.exp(track_sigma * rng.standard_normal(num_lms))
    lo, hi = 1e-6, float(num_cams)
    for _ in range(60):
        s = 0.5 * (lo + hi)
        m = np.mean(np.clip(2 + np.floor(s * z), 2, num_cams))
        if m < mean_obs_per_lm:
            lo = s
        else:
            hi = s
    k = np.clip(2 + np.floor(s * z), 2, num_cams).astype(np.int64)

    w_cap = np.maximum(k, int(np.ceil(max_window_frac * num_cams)))
    stretch = 1.0 + window_stretch * rng.pareto(1.5, num_lms)
    w = np.clip(np.ceil(k * stretch), k, w_cap).astype(np.int64)
    start = rng.integers(0, num_cams, num_lms)

    obs_lm = np.repeat(np.arange(num_lms, dtype=np.int64), k)
    cum = np.concatenate([[0], np.cumsum(k)])
    obs_off = np.arange(obs_lm.size, dtype=np.int64) - cum[obs_lm]
    r = rng.integers(0, (w - k)[obs_lm] + 1)
    order = np.lexsort((r, obs_lm))
    offset = r[order] + obs_off
    obs_cam = (start[obs_lm] + offset) % num_cams

    if p_far > 0:
        far = rng.random(obs_lm.size) < p_far
        start2 = rng.integers(0, num_cams, num_lms)
        w2 = np.maximum(k, 8)
        obs_cam[far] = (start2[obs_lm[far]]
                        + rng.integers(0, w2[obs_lm[far]])) % num_cams

    key = obs_lm * np.int64(num_cams) + obs_cam
    _, uniq = np.unique(key, return_index=True)
    uniq.sort()
    return obs_lm[uniq], obs_cam[uniq]


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _matrix_to_rodrigues(R):
    q = _quat_from_matrix(R)
    w = np.clip(q[0], -1.0, 1.0)
    v = q[1:]
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.zeros(3)
    angle = 2.0 * np.arctan2(n, w)
    if angle > np.pi:
        angle -= 2 * np.pi
    return angle * v / n


def write_bal(twin: dict, path: str, order_seed: int = None) -> None:
    """The twin as a BAL text file: header, one "cam lm u v" line per
    observation, then 9 camera and 3 landmark values one per line. With
    order_seed the observation lines come in an order drawn from it
    (a loader sorts them back: the same problem in another order)."""
    flip = np.diag([1.0, -1.0, -1.0])
    n_cams, n_lms = twin["cam_q"].shape[0], twin["lm_p"].shape[0]
    n_obs = twin["obs_lm"].shape[0]
    order = (np.arange(n_obs) if order_seed is None
             else np.random.default_rng(order_seed).permutation(n_obs))
    rows = zip(twin["obs_cam"][order].tolist(),
               twin["obs_lm"][order].tolist(),
               twin["obs_uv"][order, 0].tolist(),
               (-twin["obs_uv"][order, 1]).tolist())
    cam_vals = []
    for c in range(n_cams):
        rod = _matrix_to_rodrigues(flip @ _quat_to_matrix(twin["cam_q"][c]))
        cam_vals.extend(list(rod) + list(flip @ twin["cam_t"][c])
                        + list(twin["cam_intr"][c]))
    with open(path, "w") as fp:
        fp.write(f"{n_cams} {n_lms} {n_obs}\n")
        fp.write("".join(["%d %d %.17g %.17g\n" % row for row in rows]))
        fp.write("\n".join(f"{v:.17g}" for v in cam_vals) + "\n")
        fp.write("\n".join(f"{v:.17g}" for v in
                           twin["lm_p"].reshape(-1).tolist()) + "\n")
