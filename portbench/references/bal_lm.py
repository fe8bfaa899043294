"""The plain reference of a BAL solve, in PyTorch, and the comparison
that decides whether the program's solves are correct (`judge`).

It implements the semantics that `bal` states, with nothing of the
program: the BAL text loader with its axis flip, the preprocessing
(median/MAD normalisation, the perturbation drawn from libstdc++'s
minstd_rand0 and Marsaglia polar normal, the depth filter), the cost
0.5 sum |r|^2, and K iterations of the reference LM minimiser:
Snavely projection with radial distortion, Jacobians scaled per
landmark column and per camera column by 1 / (eps + norm), eps the
configured jacobi_scaling_epsilon or Sophus' epsilonSqrt of the
configured precision (1e-5 in float64, sqrt(1e-5) in float32), lambda
I damping of both scaled blocks, the Schur complement on the cameras
solved by preconditioned CG (block-Jacobi on the reduced system, Nash's
zeta test at eta, a residual reset every 10 iterations) or, for
POWER_SCHUR_COMPLEMENT, by the power series sum_i (Hpp^-1 E0)^i
Hpp^-1 (-b) with the same test, back substitution, the left SE(3)
increment, and the trust region update lambda *= max(1/3,
1 - (2 rho - 1)^3) on success and lambda *= vee, vee *= 2 on reject.

Every product of two arrays goes through `_prod`, so that the control
(`precision="tf32"`) rounds both operands to TF32's 10-bit mantissa, as
a tensor core would; `precision="f32"` computes in float32, "f64" in
float64. The cost is always summed in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# loading and preprocessing (host, float64)
# ---------------------------------------------------------------------------

def _qmul(a, b):
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def _qrot(q, v):
    w, u = q[..., 0:1], q[..., 1:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _qexp(omega):
    theta2 = np.sum(omega * omega, axis=-1)
    theta = np.sqrt(theta2)
    small = theta2 < 1e-16
    sinc = np.where(small, 0.5 - theta2 / 48.0,
                    np.sin(0.5 * theta) / np.where(small, 1.0, theta))
    w = np.where(small, 1.0 - theta2 / 8.0, np.cos(0.5 * theta))
    return np.concatenate([w[..., None], sinc[..., None] * omega], axis=-1)


def _qnormalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def read_bal(path: str) -> dict:
    """A BAL text file in the internal convention (positive z forward,
    y down), observations sorted by landmark, then camera."""
    with open(path, "rb") as fp:
        tok = np.fromstring(fp.read().decode(), dtype=np.float64, sep=" ")
    n_cams, n_lms, n_obs = int(tok[0]), int(tok[1]), int(tok[2])
    obs = tok[3:3 + 4 * n_obs].reshape(n_obs, 4)
    p = 3 + 4 * n_obs
    cams = tok[p:p + 9 * n_cams].reshape(n_cams, 9)
    p += 9 * n_cams
    lm_p = tok[p:p + 3 * n_lms].reshape(n_lms, 3).copy()
    obs_cam = obs[:, 0].astype(np.int64)
    obs_lm = obs[:, 1].astype(np.int64)
    if len(np.unique(obs_lm * n_cams + obs_cam)) != n_obs:
        raise ValueError(f"{path}: duplicate observation")
    uv = obs[:, 2:4].copy()
    uv[:, 1] = -uv[:, 1]
    flip_q = np.broadcast_to(np.array([0.0, 1.0, 0.0, 0.0]), (n_cams, 4))
    cam_q = _qnormalize(_qmul(flip_q, _qexp(cams[:, 0:3])))
    cam_t = cams[:, 3:6] * np.array([1.0, -1.0, -1.0])
    order = np.lexsort((obs_cam, obs_lm))
    return dict(cam_q=cam_q, cam_t=cam_t, cam_intr=cams[:, 6:9].copy(),
                lm_p=lm_p, obs_lm=obs_lm[order], obs_cam=obs_cam[order],
                obs_uv=uv[order])


_MINSTD_A, _MINSTD_M = 16807, 2147483647


def _minstd_stream(seed: int, n: int) -> np.ndarray:
    """The first n outputs of minstd_rand0 seeded with `seed`:
    x_k = a^k x_0 mod m, a block of a^1..a^B at a time."""
    x0 = seed % _MINSTD_M or 1
    B = 4096
    powers = np.empty(B, dtype=np.int64)
    acc = 1
    for i in range(B):
        acc = acc * _MINSTD_A % _MINSTD_M
        powers[i] = acc
    step = int(powers[-1])
    out = np.empty(-(-n // B) * B, dtype=np.int64)
    x = x0
    for j in range(0, out.size, B):
        out[j:j + B] = powers * x % _MINSTD_M
        x = x * step % _MINSTD_M
    return out[:n]


def _normal_triples(seed: int, calls: int) -> np.ndarray:
    """[calls, 3] draws of libstdc++'s normal_distribution<double> on
    minstd_rand0, a fresh distribution per call of three draws: each
    candidate of the polar method takes four engine outputs (two
    generate_canonical of two outputs each), and a call takes the two
    values of its first accepted candidate and the first of its
    second."""
    r = 2147483646.0
    need = 2 * calls
    n_cand = int(need / 0.78) + 64
    while True:
        e = _minstd_stream(seed, 4 * n_cand).reshape(n_cand, 4)
        e = (e - 1).astype(np.float64)
        u1 = (e[:, 0] + e[:, 1] * r) / (r * r)
        u2 = (e[:, 2] + e[:, 3] * r) / (r * r)
        below_one = math.nextafter(1.0, 0.0)
        u1 = np.minimum(u1, below_one)
        u2 = np.minimum(u2, below_one)
        x = 2.0 * u1 - 1.0
        y = 2.0 * u2 - 1.0
        r2 = x * x + y * y
        ok = (r2 <= 1.0) & (r2 != 0.0)
        if ok.sum() >= need:
            break
        n_cand *= 2
    x, y, r2 = x[ok][:need], y[ok][:need], r2[ok][:need]
    mult = np.sqrt(-2.0 * np.log(r2) / r2)
    first = slice(0, need, 2)
    second = slice(1, need, 2)
    return np.stack([y[first] * mult[first], x[first] * mult[first],
                     y[second] * mult[second]], axis=1)


def preprocess(p: dict, dataset: dict) -> dict:
    """Normalise, perturb and filter as the dataset options state."""
    p = {k: v.copy() for k, v in p.items()}
    if dataset.get("normalize", True):
        n = p["lm_p"].shape[0]
        k = n // 2
        median = np.partition(p["lm_p"], k, axis=0)[k]
        dev = np.sum(np.abs(p["lm_p"] - median), axis=1)
        scale = dataset["normalization_scale"] / np.partition(dev, k)[k]
        p["lm_p"] = scale * (p["lm_p"] - median)
        qinv = p["cam_q"] * np.array([1.0, -1.0, -1.0, -1.0])
        center = scale * (_qrot(qinv, -p["cam_t"]) - median)
        p["cam_t"] = -_qrot(p["cam_q"], center)
    rs = dataset.get("rotation_sigma", 0.0)
    ts = dataset.get("translation_sigma", 0.0)
    ps = dataset.get("point_sigma", 0.0)
    if rs > 0 or ts > 0 or ps > 0:
        n_cams = p["cam_q"].shape[0]
        per_cam = int(ts > 0) + int(rs > 0)
        calls = n_cams * per_cam + (p["lm_p"].shape[0] if ps > 0 else 0)
        draws = _normal_triples(dataset["random_seed"], calls)
        cam_draws = draws[:n_cams * per_cam].reshape(n_cams, per_cam, 3)
        j = 0
        if ts > 0:
            qinv = p["cam_q"] * np.array([1.0, -1.0, -1.0, -1.0])
            center = _qrot(qinv, -p["cam_t"]) + cam_draws[:, j] * ts
            p["cam_t"] = -_qrot(p["cam_q"], center)
            j += 1
        if rs > 0:
            dq = _qexp(cam_draws[:, j] * rs)
            p["cam_q"] = _qnormalize(_qmul(dq, p["cam_q"]))
        if ps > 0:
            p["lm_p"] = p["lm_p"] + draws[n_cams * per_cam:] * ps
    thr = dataset.get("init_depth_threshold", 0.0)
    if thr > 0:
        z = (_qrot(p["cam_q"][p["obs_cam"]], p["lm_p"][p["obs_lm"]])
             + p["cam_t"][p["obs_cam"]])[:, 2]
        keep = z >= thr
        for k in ("obs_lm", "obs_cam", "obs_uv"):
            p[k] = p[k][keep]
        counts = np.bincount(p["obs_lm"], minlength=p["lm_p"].shape[0])
        keep_lm = counts >= 2
        new_idx = np.cumsum(keep_lm) - 1
        keep_obs = keep_lm[p["obs_lm"]]
        p["obs_lm"] = new_idx[p["obs_lm"][keep_obs]]
        p["obs_cam"] = p["obs_cam"][keep_obs]
        p["obs_uv"] = p["obs_uv"][keep_obs]
        p["lm_p"] = p["lm_p"][keep_lm]
    return p


# ---------------------------------------------------------------------------
# the solve (torch, on any device)
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest."""
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Solver:
    def __init__(self, p: dict, solver: dict, device, precision: str):
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.tf32 = precision == "tf32"
        self.dev = torch.device(device)
        self.opts = solver
        dt = self.dtype
        self.cam = torch.as_tensor(p["obs_cam"], device=self.dev)
        self.lm = torch.as_tensor(p["obs_lm"], device=self.dev)
        self.uv = torch.as_tensor(p["obs_uv"], dtype=dt, device=self.dev)
        self.N = p["cam_q"].shape[0]
        self.M = p["lm_p"].shape[0]
        eps = solver.get("jacobi_scaling_epsilon", 0.0)
        self.eps = (eps if eps > 0 else
                    1e-5 if solver["use_double"] else math.sqrt(1e-5))

    def _prod(self, eq, a, b):
        if self.tf32:
            a, b = _tf32(a), _tf32(b)
        return torch.einsum(eq, a, b)

    def _sum_to(self, rows, idx, n):
        out = rows.new_zeros((n,) + rows.shape[1:])
        return out.index_add_(0, idx, rows)

    @staticmethod
    def _rotmat(q):
        w, x, y, z = q.unbind(-1)
        return torch.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], dim=-1).reshape(-1, 3, 3)

    def residuals(self, s, jacobians: bool = False):
        R = self._rotmat(s["q"])[self.cam]
        Xo = s["X"][self.lm]
        pc = self._prod("oij,oj->oi", R, Xo) + s["t"][self.cam]
        x, y, z = pc.unbind(-1)
        zinv = 1.0 / z
        d = torch.stack([x * zinv, y * zinv], dim=-1)
        r2 = torch.sum(d * d, dim=-1)
        intr = s["intr"][self.cam]
        f, k1, k2 = intr.unbind(-1)
        rp = 1.0 + r2 * (k1 + r2 * k2)
        res = (f * rp)[:, None] * d - self.uv
        if not jacobians:
            return res
        O = res.shape[0]
        Dd = res.new_zeros((O, 2, 3))
        Dd[:, 0, 0] = zinv
        Dd[:, 0, 2] = -x * zinv * zinv
        Dd[:, 1, 1] = zinv
        Dd[:, 1, 2] = -y * zinv * zinv
        dr2 = 2.0 * (d[:, 0:1] * Dd[:, 0] + d[:, 1:2] * Dd[:, 1])
        J = ((f * rp)[:, None, None] * Dd
             + (f * (k1 + 2.0 * k2 * r2))[:, None, None]
             * d[:, :, None] * dr2[:, None, :])
        hat = pc.new_zeros((O, 3, 3))
        hat[:, 0, 1], hat[:, 0, 2] = -pc[:, 2], pc[:, 1]
        hat[:, 1, 0], hat[:, 1, 2] = pc[:, 2], -pc[:, 0]
        hat[:, 2, 0], hat[:, 2, 1] = -pc[:, 1], pc[:, 0]
        Jp = torch.cat([J, -self._prod("oij,ojk->oik", J, hat),
                        (rp[:, None] * d)[:, :, None],
                        ((f * r2)[:, None] * d)[:, :, None],
                        ((f * r2 * r2)[:, None] * d)[:, :, None]], dim=2)
        Jl = self._prod("oij,ojk->oik", J, R)
        return res, Jp, Jl

    def cost(self, s) -> float:
        res = self.residuals(s)
        return float(0.5 * torch.sum((res * res).sum(-1).double()))

    def linearize(self, s):
        r, Jp, Jl = self.residuals(s, jacobians=True)
        colsq = self._sum_to((Jl * Jl).sum(1), self.lm, self.M)
        self.jl_scale = 1.0 / (self.eps + torch.sqrt(colsq))
        Jl = Jl * self.jl_scale[self.lm][:, None, :]
        diag2 = self._sum_to((Jp * Jp).sum(1), self.cam, self.N)
        self.pose_scale = (1.0 / (self.eps + torch.sqrt(diag2))
                           if self.opts.get("jacobi_scaling", True)
                           else torch.ones_like(diag2))
        Jp = Jp * self.pose_scale[self.cam][:, None, :]
        self.r, self.Jp, self.Jl = r, Jp, Jl
        self.W = self._prod("ori,orj->oij", Jp, Jl)          # [O, 9, 3]
        self.U = self._sum_to(self._prod("ori,orj->oij", Jp, Jp),
                              self.cam, self.N)               # [N, 9, 9]
        self.Hll0 = self._sum_to(self._prod("ori,orj->oij", Jl, Jl),
                                 self.lm, self.M)             # [M, 3, 3]
        self.bl = self._sum_to(self._prod("ori,or->oi", Jl, r),
                               self.lm, self.M)
        self.bp = self._sum_to(self._prod("ori,or->oi", Jp, r),
                               self.cam, self.N)

    def stage2(self, lam):
        eye3 = torch.eye(3, dtype=self.dtype, device=self.dev)
        eye9 = torch.eye(9, dtype=self.dtype, device=self.dev)
        self.Hinv = torch.linalg.inv(self.Hll0 + lam * eye3)
        y = self._prod("lij,lj->li", self.Hinv, self.bl)
        self.b = self.bp - self._sum_to(
            self._prod("oij,oj->oi", self.W, y[self.lm]), self.cam, self.N)
        self.Hpp = self.U + lam * eye9
        WH = self._prod("oij,ojk->oik", self.W, self.Hinv[self.lm])
        self.Sdiag = self.Hpp - self._sum_to(
            self._prod("oij,okj->oik", WH, self.W), self.cam, self.N)

    def e0(self, x):
        """W Hll^-1 W' x, the part of the reduced system the landmarks
        take away from Hpp."""
        wx = self._sum_to(self._prod("oij,oi->oj", self.W, x[self.cam]),
                          self.lm, self.M)
        hw = self._prod("lij,lj->li", self.Hinv, wx)
        return self._sum_to(self._prod("oij,oj->oi", self.W, hw[self.lm]),
                            self.cam, self.N)

    def matvec(self, x):
        return self._prod("nij,nj->ni", self.Hpp, x) - self.e0(x)

    def pcg(self, b, precond):
        o = self.opts
        max_it = o.get("max_linear_solver_iterations", 500)
        min_it = o.get("min_linear_solver_iterations", 0)
        eta = o.get("eta", 0.1)

        def dot(a, c):
            return torch.sum(a * c)

        x = torch.zeros_like(b)
        r = p = b
        rho = b.new_ones(())
        q0 = b.new_zeros(())
        i = 0
        while i < max_it:
            i += 1
            z = precond(r)
            last_rho, rho = rho, dot(r, z)
            beta = rho / (last_rho if float(last_rho) != 0 else 1.0)
            p = z if i == 1 else z + beta * p
            q = self.matvec(p)
            pq = dot(p, q)
            failed = (float(rho) == 0 or math.isinf(float(rho))
                      or (i > 1 and (float(beta) == 0
                                     or math.isinf(float(beta)))))
            indefinite = float(pq) <= 0 or math.isinf(float(pq))
            alpha = rho / (pq if float(pq) != 0 else 1.0)
            failed = failed or math.isinf(float(alpha))
            if failed or indefinite:
                break
            x = x + alpha * p
            r = b - self.matvec(x) if i % 10 == 0 else r - alpha * q
            q1 = -dot(x, b + r)
            zeta = i * (q1 - q0) / q1
            q0 = q1
            if float(zeta) < eta and i >= min_it:
                break
        return x, i

    def power_series(self, b):
        o = self.opts
        hinv = torch.linalg.inv(self.Hpp)

        def apply_hinv(v):
            return self._prod("nij,nj->ni", hinv, v)

        acc = tmp = apply_hinv(-b)
        i = 0
        while i < o.get("power_order", 10):
            i += 1
            tmp = apply_hinv(self.e0(tmp))
            acc = acc + tmp
            zeta = i * torch.linalg.vector_norm(tmp) / \
                torch.linalg.vector_norm(acc)
            if float(zeta) < o.get("eta", 0.1):
                break
        return acc, i

    def solve(self, lam):
        """The scaled camera increment of this linearisation at lam."""
        self.stage2(lam)
        if self.opts["solver_type"] == "POWER_SCHUR_COMPLEMENT":
            return self.power_series(self.b)
        pinv = torch.linalg.inv(self.Sdiag)
        x, iters = self.pcg(self.b, lambda v: self._prod(
            "nij,nj->ni", pinv, v))
        return -x, iters

    def step(self, s, dp):
        """(new state, l_diff) of the scaled increment dp."""
        jpdp = self._prod("ori,oi->or", self.Jp, dp[self.cam])
        t3 = self._sum_to(self._prod("ori,or->oi", self.Jl, jpdp + self.r),
                          self.lm, self.M)
        dl = -self._prod("lij,lj->li", self.Hinv, t3)
        v = jpdp + self._prod("ori,oi->or", self.Jl, dl[self.lm])
        l_diff = -float(torch.sum((v * (0.5 * v + self.r)).double()))
        inc = dp * self.pose_scale
        w = inc[:, 3:6]
        theta2 = torch.sum(w * w, dim=-1)
        theta = torch.sqrt(theta2)
        small = theta2 < 1e-16
        sinc = torch.where(small, 0.5 - theta2 / 48.0,
                           torch.sin(0.5 * theta)
                           / torch.where(small, torch.ones_like(theta),
                                         theta))
        dq = torch.cat([torch.where(small, 1.0 - theta2 / 8.0,
                                    torch.cos(0.5 * theta))[:, None],
                        sinc[:, None] * w], dim=-1)
        q = _tqmul(dq, s["q"])
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        t = _tqrot(dq, s["t"]) + inc[:, 0:3]
        new = dict(q=q, t=t, intr=s["intr"] + inc[:, 6:9],
                   X=s["X"] + dl * self.jl_scale)
        finite = all(bool(torch.isfinite(v).all()) for v in new.values())
        return new, l_diff, finite


def _tqmul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def _tqrot(q, v):
    w, u = q[..., 0:1], q[..., 1:4]
    uv = torch.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.cross(u, uv, dim=-1))


def _state(p: dict, dtype, device) -> dict:
    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(q=up(p["cam_q"]), t=up(p["cam_t"]), intr=up(p["cam_intr"]),
                X=up(p["lm_p"]))


def cost(p: dict, state: dict, device) -> float:
    """The float64 cost 0.5 sum |r|^2 of p's observations at `state`
    (host arrays cam_q, cam_t, cam_intr, lm_p)."""
    s = _Solver(p, dict(use_double=True), device, "f64")
    return s.cost(_state(state, torch.float64, device))


def solve(p: dict, solver: dict, iterations: int, device,
          precision: str = "f64") -> dict:
    """K = iterations LM iterations from p's state: {"costs": the cost
    after each iteration (iteration 0 the start), "final_cost": that of
    the last successful one, "state": its host arrays}."""
    sv = _Solver(p, solver, device, precision)
    s = _state(p, sv.dtype, device)
    f = sv.cost(s)
    costs = [f]
    lam = 1.0 / solver.get("initial_trust_region_radius", 1e4)
    vee0 = solver.get("initial_vee", 2.0)
    vee = vee0
    min_lam = 1.0 / solver.get("max_trust_region_radius", 1e16)
    max_lam = 1.0 / solver.get("min_trust_region_radius", 1e-32)
    ftol = solver.get("function_tolerance", 1e-6)
    min_rel = solver.get("min_relative_decrease", 0.0)
    it, fresh = 1, False
    while it <= iterations:
        if not fresh:
            sv.linearize(s)
            fresh = True
        dp, _ = sv.solve(lam)
        new, l_diff, finite = sv.step(s, dp)
        f_new = sv.cost(new) if finite else math.nan
        rho = (f - f_new) / (l_diff if l_diff != 0 else 1.0)
        valid = finite and math.isfinite(l_diff) and math.isfinite(f_new) \
            and l_diff > 0
        success = valid and rho > min_rel
        t3 = 2.0 * rho - 1.0
        costs.append(f_new)
        it += 1
        if success:
            done = abs(f - f_new) <= ftol * f_new
            lam = max(min_lam, lam * max(1.0 / 3.0, 1.0 - t3 * t3 * t3))
            vee = vee0
            s, f, fresh = new, f_new, False
            if done:
                break
        else:
            lam *= vee
            vee *= solver.get("vee_factor", 2.0)
            if lam > max_lam:
                break
    host = {k: v.double().cpu().numpy() for k, v in s.items()}
    return dict(costs=costs, final_cost=f,
                state=dict(cam_q=host["q"], cam_t=host["t"],
                           cam_intr=host["intr"], lm_p=host["X"]))


def _gap(a: float, b: float) -> float:
    g = abs(a - b) / abs(b) if b != 0 else abs(a)
    return g if math.isfinite(g) else math.inf


def judge(path: str, dataset: dict, solver: dict, iterations: int,
          answers: list, device) -> list:
    """The numbers that decide `correct`, one dict per answer. An
    answer is one solve: a dict of the solved problem's observations
    (obs_lm, obs_cam, obs_uv) and final state (cam_q, cam_t, cam_intr,
    lm_p), and the costs the solve reported (initial_cost, final_cost).

    obs_mismatch    observations that differ from the reference's
                    loaded and preprocessed ones, plus the differences
                    in the numbers of observations and landmarks;
    cost0_gap       relative gap of the reported initial cost to the
                    reference's at its own preprocessed start (load,
                    preprocess, cost);
    state_cost_gap  relative gap of the reported final cost to the
                    reference's cost of the returned state (the state
                    handed back is the one the solve reports);
    solve_gap       relative gap of the reported final cost to the
                    reference's after the same K LM iterations from the
                    same start (linearisation, reduced solve, back
                    substitution, update)."""
    import sys
    import time

    t0 = time.monotonic()
    p = preprocess(read_bal(path), dataset)
    t1 = time.monotonic()
    ref = solve(p, solver, iterations, device)
    t2 = time.monotonic()
    out = []
    for a in answers:
        n = abs(a["obs_lm"].shape[0] - p["obs_lm"].shape[0])
        n += abs(a["lm_p"].shape[0] - p["lm_p"].shape[0])
        if n == 0:
            differs = ((a["obs_lm"] != p["obs_lm"])
                       | (a["obs_cam"] != p["obs_cam"])
                       | np.any(a["obs_uv"] != p["obs_uv"], axis=1))
            n = int(differs.sum())
            c = cost(p, a, device)
        else:
            c = math.inf
        out.append(dict(obs_mismatch=n,
                        cost0_gap=_gap(a["initial_cost"], ref["costs"][0]),
                        state_cost_gap=_gap(a["final_cost"], c),
                        solve_gap=_gap(a["final_cost"], ref["final_cost"])))
    print(f"[reference] load and preprocess {t1 - t0:.3f} s, {iterations} "
          f"LM iterations {t2 - t1:.3f} s, {len(answers)} answers "
          f"{time.monotonic() - t2:.3f} s", file=sys.stderr, flush=True)
    return out
