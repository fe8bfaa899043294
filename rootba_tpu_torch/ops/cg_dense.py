"""K3: the whole dense-RCS PCG loop as one kernel (float32).

Counterpart of the JAX package's `ops/pallas_cg.py`. `pcg_dense` is a
drop-in `pcg()` for the explicit dense reduced camera system: the
feature-major ("z-space") padded matrix Hz [M, M], M = 9 * Nc (see
solver.linearization.assemble_rcs_dense), the block-Cholesky
preconditioner as 81 planar rows [81, Nc] padded with identity
(`chol_planes`), vectors as [9, Nc] planes. Its plain twin
`pcg_dense_plain` is the Pallas kernel's loop (`_cg_kernel`) in
PyTorch, with plain float32 dots.

Three kernels in csrc/cg_dense.cu compute it on the card; `k3_plan`
chooses one by size before the launch. Two hold the system in the
shared memory of one thread-block cluster of 16 CTAs: the full-row
kernel ("cluster") the real 9N x 9N rows while a CTA's slab fits in
227 KB, the half kernel ("half") only the upper triangle of the
symmetric system, up to 128 cameras; the grid kernel (a cooperative
launch of one CTA per SM) takes the larger systems: it deals the real
lanes and their rows over the SMs, holds the rows in shared memory
where they fit (up to 264 cameras on 132 SMs) and streams the rest
every product, up to 2100 cameras (`grid_plan`). A refused launch of
any raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rootba_tpu_torch.log import trace
from rootba_tpu_torch.ops import kernels
from rootba_tpu_torch.solver.cg import (
    CG_FAILURE,
    CG_NO_CONVERGENCE,
    CG_RUNNING,
    CG_SUCCESS,
    CGResult,
)

D = 9
# shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
# The cluster kernel's capacity, as csrc/cg_dense.cu's cluster_plan has
# it (the card test holds k3_plan equal to rb_pcg_dense_cluster_plan):
# CTAs in its cluster (kCluster, a non-portable size on the H100)
CLUSTER = 16
# camera lanes, one thread each (kLaneWarps x 32)
MAX_LANES = 96
# 16-byte chunks of a slab row in the prologue's copy (32 x kMaxRowChunks)
MAX_ROW_CHUNKS = 224
# rows of Hz one CTA holds at most (kRowsPerWarp x kCWarps)
MAX_ROWS_PER_CTA = 80
# the half kernel: camera lanes (kHLaneWarps x 32)
HALF_MAX_LANES = 128
# ... and rows of a CTA's triangle share (kHRows x kCWarps)
HALF_MAX_ROWS_PER_CTA = 72
# rb_pcg_dense_cluster_plan's answer -> the kernel k3_plan names
PLAN_KERNELS = ("grid", "cluster", "half")
# The grid kernel's plan, as csrc/cg_dense.cu's grid_plan has it (the
# card test holds k3_plan equal to rb_pcg_dense_grid_plan): one CTA per
# SM, at most one per camera. The launch plans on its card's SMs
# (card_sms); k3_plan's default is the H100 SXM's
GRID_CTAS = 132
# camera lanes per CTA, one thread each of its warp 0 (kGMaxLanes)
GRID_MAX_LANES = 32
# warps per CTA (kGWarps): one row sum each per row
GRID_WARPS = 8
# bytes of streamed rows per ring stage (kGStageBytes; 1 to
# GRID_MAX_STAGE_ROWS rows) and in flight per CTA (kGRingBytes; 2 to
# GRID_MAX_STAGES stages)
GRID_STAGE_BYTES = 32 * 1024
GRID_MAX_STAGE_ROWS = 4
GRID_RING_BYTES = 64 * 1024
GRID_MAX_STAGES = 8
# each kernel's entry in csrc/cg_dense.cu
ENTRIES = {"grid": "rb_pcg_dense_f32", "cluster": "rb_pcg_dense_cluster_f32",
           "half": "rb_pcg_dense_half_f32"}


class K3Plan(NamedTuple):
    kernel: str        # "cluster", "half" or "grid"
    cluster: int       # CTAs in the cluster (0: the grid kernel)
    rows_per_cta: int  # rows of Hz resident in each CTA (grid: at most)
    smem_bytes: int    # dynamic shared memory per block
    ctas: int = CLUSTER  # CTAs of the launch
    streamed: int = 0  # rows streamed per product by the largest CTA
    stages: int = 0    # the grid kernel's ring stages ...
    stage_rows: int = 0  # ... of this many rows each


def cluster_smem_bytes(N: int, rows_per_cta: int) -> int:
    """Shared memory of one CTA of the cluster kernel
    (csrc/cg_dense.cu, cluster_smem_bytes): 32 bytes of mbarriers, then
    floats -- its slab of rows_per_cta real rows and the vectors p, x,
    q, q', Hx, each of row length ld = 9 * Np (Np = N rounded up to 4),
    Lp's 45 lower planes (45 Np), the pq partials (2 x 16 CTAs x 8 warps)
    and the reduction scratch (2 x 3 x 8)."""
    Np = (N + 3) // 4 * 4
    ld = 9 * Np
    return 32 + 4 * (rows_per_cta * ld + 5 * ld + 45 * Np
                     + 2 * CLUSTER * 8 + 6 * 8)


def half_lanes(N: int) -> int:
    """Lanes per feature plane of the half kernel's layout: N rounded up
    to 8 (half_lanes in csrc/cg_dense.cu), so that its ld = 9 Np rows
    pair up into a multiple of 4 pairs."""
    return (N + 7) // 8 * 8


def half_pairs_per_cta(N: int) -> int:
    """Row pairs (r, ld - 1 - r) of the half kernel's triangle per CTA:
    ceil(ld / 2 / 16) rounded up to 4, ld = 9 half_lanes(N)."""
    ld = 9 * half_lanes(N)
    return (-(-(ld // 2) // CLUSTER) + 3) // 4 * 4


def half_smem_bytes(N: int, pairs_per_cta: int) -> int:
    """Shared memory of one CTA of the half kernel (csrc/cg_dense.cu,
    half_smem_bytes): 48 bytes of mbarriers, then floats -- its triangle
    share of pairs_per_cta pairs of ld + 4, the vectors p, x, q, q', Hx
    (ld each), Lp's 45 lower planes (45 Np), the rows' places (4 words
    each), the column sums received by parity (2 x 16 x 2 pairs_per_cta),
    the row sums (2 pairs_per_cta), the pq partials, the reduction
    scratch and a buffer of round 1's column sums (ld)."""
    Np = half_lanes(N)
    ld = 9 * Np
    return 48 + 4 * (pairs_per_cta * (ld + 4) + 6 * ld + 45 * Np
                     + 4 * 2 * pairs_per_cta
                     + (2 * CLUSTER + 1) * 2 * pairs_per_cta
                     + 2 * CLUSTER * 8 + 6 * 8)


def half_fits(N: int) -> bool:
    """Whether the half kernel takes N cameras (half_plan in
    csrc/cg_dense.cu): a lane per thread of its lane warps, at most
    HALF_MAX_ROWS_PER_CTA rows of the share per CTA, and its shared
    memory within 227 KB."""
    pairs = half_pairs_per_cta(N)
    return (1 <= N <= HALF_MAX_LANES and 2 * pairs <= HALF_MAX_ROWS_PER_CTA
            and half_smem_bytes(N, pairs) <= SMEM_LIMIT)


def grid_lanes(N: int) -> int:
    """Lanes per feature plane of the grid kernel's layout: N rounded up
    to 4 (grid_lanes in csrc/cg_dense.cu)."""
    return (N + 3) // 4 * 4


def grid_plan(N: int, sms: int = GRID_CTAS) -> Optional[K3Plan]:
    """The grid kernel's plan for N cameras on `sms` SMs (grid_plan in
    csrc/cg_dense.cu), None where it does not take N. G = min(sms, N)
    CTAs (1 for N = 0); the largest holds L = ceil(N / G) lanes and their
    R = 9 L rows of ld = 9 grid_lanes(N) floats. Its shared memory: the
    ring's mbarriers (2 GRID_MAX_STAGES floats), v (ld), the 8 warps'
    row sums and the row sums (9 R) and 8 scalars, then row slots of ld
    floats: all R rows where they fit in 227 KB; else the ring's stages
    (of GRID_STAGE_BYTES of rows, 1 to GRID_MAX_STAGE_ROWS; as many as
    GRID_RING_BYTES holds, 2 to GRID_MAX_STAGES, at most one per group
    of streamed rows) and as many resident rows as the rest holds, the
    other rows streamed every product."""
    if N < 0 or sms < 1:
        return None
    G = max(1, min(sms, N))
    L = -(-N // G)
    R = 9 * L
    ld = 9 * grid_lanes(N)
    cap = SMEM_LIMIT // 4
    fixed = 2 * GRID_MAX_STAGES + ld + (GRID_WARPS + 1) * R + 8
    resident, streamed, stages, sr = R, 0, 0, 0
    if fixed + R * ld > cap:
        sr = min(max(GRID_STAGE_BYTES // (4 * ld), 1), GRID_MAX_STAGE_ROWS)
        st = min(max(GRID_RING_BYTES // (4 * ld * sr), 2), GRID_MAX_STAGES)
        fit = (cap - fixed) // ld
        if fixed > cap or fit < st * sr:
            return None
        resident = fit - st * sr
        streamed = R - resident
        stages = min(st, -(-streamed // sr))
    smem = 4 * (fixed + (resident + stages * sr) * ld)
    if L > GRID_MAX_LANES or smem > SMEM_LIMIT:
        return None
    return K3Plan("grid", 0, resident, smem, G, streamed, stages, sr)


def _grid_plan_checked(N: int, sms: int) -> K3Plan:
    """grid_plan, raising where the grid kernel does not take N."""
    plan = grid_plan(N, sms)
    if plan is None:
        raise ValueError(
            f"pcg_dense: {N} cameras > {grid_max_cameras(sms)}, the grid "
            f"kernel's capacity on {sms} SMs (its vector and two row "
            f"stages fill a CTA's shared memory)")
    return plan


def grid_max_cameras(sms: int = GRID_CTAS) -> int:
    """The most cameras the grid kernel takes on `sms` SMs (2100 on
    132): from there on v and the ring's two row stages no longer fit
    one CTA's shared memory."""
    n = 1
    while grid_plan(n + 1, sms) is not None:
        n += 1
    return n


def grid_work_floats(N: int, ctas: int) -> int:
    """Floats of the grid kernel's work buffer (grid_work_floats in
    csrc/cg_dense.cu): the gathered z, p and x (9 grid_lanes(N) each),
    two float4 partials per CTA and the exchanges' counter (4 floats)."""
    return 3 * 9 * grid_lanes(N) + 8 * ctas + 4


def k3_plan(N: int, Nc: int, sms: int = GRID_CTAS) -> K3Plan:
    """Which K3 kernel solves an N-camera system on Nc lanes: the
    full-row cluster kernel while its lanes, rows and shared memory hold
    the system (cluster_plan in csrc/cg_dense.cu), else the half kernel
    while its lanes and shared memory do (half_plan), else the grid
    kernel on `sms` SMs (grid_plan); raises above the grid kernel's
    capacity."""
    if not 0 <= N <= Nc:
        raise ValueError(f"k3_plan: needs 0 <= N <= Nc, got N={N}, Nc={Nc}")
    rows = -(-9 * N // CLUSTER)
    smem = cluster_smem_bytes(N, rows)
    if (1 <= N <= MAX_LANES and 9 * ((N + 3) // 4) <= MAX_ROW_CHUNKS
            and rows <= MAX_ROWS_PER_CTA and smem <= SMEM_LIMIT):
        return K3Plan("cluster", CLUSTER, rows, smem)
    if half_fits(N):
        pairs = half_pairs_per_cta(N)
        return K3Plan("half", CLUSTER, 2 * pairs, half_smem_bytes(N, pairs))
    return _grid_plan_checked(N, sms)


def chol_planes(chol: torch.Tensor, Nc: int) -> torch.Tensor:
    """[N,9,9] lower factors -> [81, Nc] planar rows (row i*9+j =
    L[:, i, j]), identity beyond N so padded lanes solve to zero."""
    N = chol.shape[0]
    pad = torch.zeros((81, Nc - N), dtype=chol.dtype, device=chol.device)
    # the list index and the value are uploaded, each with a stream sync
    with trace.sync("k3_planes"):
        pad[[i * D + i for i in range(D)], :] = 1.0
    return torch.cat([chol.reshape(N, 81).T, pad], dim=1).contiguous()


def _solve_planar(Lp: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 r for planar factors Lp [81, Nc] and r2 [9, Nc]."""
    def at(a, c):
        return Lp[a * D + c]

    y = [None] * D
    for i in range(D):
        s = r2[i]
        for k in range(i):
            s = s - at(i, k) * y[k]
        y[i] = s / at(i, i)
    z = [None] * D
    for i in reversed(range(D)):
        s = y[i]
        for k in range(i + 1, D):
            s = s - at(k, i) * z[k]
        z[i] = s / at(i, i)
    return torch.stack(z, dim=0)


def pcg_dense_plain(Hz, b2, Lp, *, min_iters: int, max_iters: int,
                    q_tol: float, r_tol: float, reset_period: int):
    """The kernel's loop in PyTorch: (x2 [9, Nc], stats [4] =
    [iterations, termination, zeta, |r|]), all float32."""
    M = Hz.shape[0]
    Nc = M // D

    def matvec(v2):
        return torch.mv(Hz, v2.reshape(M)).reshape(D, Nc)

    def dot(a, c):
        return torch.sum(a * c)

    b = b2
    norm_b = torch.sqrt(dot(b, b))
    tol_r = r_tol * norm_b
    x = torch.zeros_like(b)
    r = b
    p = b
    rho = b.new_full((), 1.0)
    q0 = b.new_zeros(())
    term = CG_RUNNING
    i = 0
    while term == CG_RUNNING and i < max_iters:
        i += 1
        z = _solve_planar(Lp, r)
        last_rho = rho
        rho = dot(r, z)
        fail_rho = bool((rho == 0) | torch.isinf(rho))
        beta = rho / torch.where(last_rho == 0, torch.ones_like(last_rho),
                                 last_rho)
        fail_beta = i > 1 and bool((beta == 0) | torch.isinf(beta))
        p = z if i == 1 else z + beta * p
        q = matvec(p)
        pq = dot(p, q)
        indefinite = bool((pq <= 0) | torch.isinf(pq))
        alpha = rho / torch.where(pq == 0, torch.ones_like(pq), pq)
        fail_alpha = bool(torch.isinf(alpha))
        failed = fail_rho or fail_beta or fail_alpha
        alpha_eff = (torch.zeros_like(alpha) if failed or indefinite
                     else alpha)
        x = x + alpha_eff * p
        if i % reset_period == 0:
            r = b - matvec(x)
        else:
            r = r - alpha_eff * q
        q1 = -dot(x, b + r)
        zeta = float(i) * (q1 - q0) / q1
        norm_r = torch.sqrt(dot(r, r))
        done = (bool((zeta < q_tol) | (norm_r <= tol_r))
                and i >= min_iters)
        term = (CG_FAILURE if failed else CG_NO_CONVERGENCE if indefinite
                else CG_SUCCESS if done else CG_RUNNING)
        q0 = q1

    if float(norm_b) == 0:
        term = CG_SUCCESS
        x = torch.zeros_like(x)
    elif term == CG_RUNNING:
        term = CG_NO_CONVERGENCE
    q1 = -dot(x, b + r)
    zeta = float(i) * (q1 - q0) / torch.where(q1 == 0, torch.ones_like(q1),
                                              q1)
    stats = torch.stack([b.new_full((), float(i)),
                         b.new_full((), float(term)), zeta,
                         torch.sqrt(dot(r, r))])
    return x, stats


def _launch_in_cluster(kernel, Hz, b2, Lp, N, *, min_iters, max_iters,
                       q_tol, r_tol, reset_period):
    """A cluster kernel ("cluster" or "half") on N real cameras of the
    Nc-lane system."""
    Nc = Hz.shape[0] // D
    lib = kernels.load("cg_dense")
    x2 = torch.empty((D, Nc), dtype=torch.float32, device=Hz.device)
    stats = torch.empty(4, dtype=torch.float32, device=Hz.device)
    entry = getattr(lib, ENTRIES[kernel])
    kernels.check(entry(
        Hz.data_ptr(), b2.data_ptr(), Lp.data_ptr(), x2.data_ptr(),
        stats.data_ptr(), N, Nc, max_iters, min_iters, q_tol, r_tol,
        reset_period, kernels.stream_ptr(Hz)), f"pcg_dense_{kernel}")
    kernels.LAUNCHES[f"pcg_dense_{kernel}"] += 1
    return x2, stats


def card_sms(device) -> int:
    """SMs of the card that holds `device`: the grid kernel's CTAs, as
    its launch (rb_pcg_dense_f32) reads them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_grid(Hz, b2, Lp, N, *, min_iters, max_iters, q_tol, r_tol,
                 reset_period, plan: Optional[K3Plan] = None):
    """The grid kernel on N real cameras of the Nc-lane system, one CTA
    per SM of Hz's card (`plan`: grid_plan on them, planned here if not
    given)."""
    Nc = Hz.shape[0] // D
    if plan is None:
        plan = _grid_plan_checked(N, card_sms(Hz.device))
    lib = kernels.load("cg_dense")
    x2 = torch.empty((D, Nc), dtype=torch.float32, device=Hz.device)
    stats = torch.empty(4, dtype=torch.float32, device=Hz.device)
    work = torch.empty(grid_work_floats(N, plan.ctas), dtype=torch.float32,
                       device=Hz.device)
    kernels.check(getattr(lib, ENTRIES["grid"])(
        Hz.data_ptr(), b2.data_ptr(), Lp.data_ptr(), x2.data_ptr(),
        stats.data_ptr(), work.data_ptr(), work.numel(), N, Nc, max_iters,
        min_iters, q_tol, r_tol, reset_period, kernels.stream_ptr(Hz)),
        "pcg_dense_grid")
    kernels.LAUNCHES["pcg_dense_grid"] += 1
    return x2, stats


def _launch(Hz, b2, Lp, N, **kw):
    """The K3 kernel that k3_plan chooses for N cameras on Hz's lanes
    and the SMs of Hz's card."""
    plan = k3_plan(N, Hz.shape[0] // D, card_sms(Hz.device))
    if plan.kernel == "grid":
        return _launch_grid(Hz, b2, Lp, N, plan=plan, **kw)
    return _launch_in_cluster(plan.kernel, Hz, b2, Lp, N, **kw)


def pcg_dense(Hz: torch.Tensor, chol: torch.Tensor, b: torch.Tensor, *,
              min_num_iterations: int = 0, max_num_iterations: int = 500,
              residual_reset_period: int = 10, q_tolerance: float = 0.1,
              r_tolerance: float = -1.0) -> CGResult:
    """Solve Hz x = b (z-space) with the block-Cholesky preconditioner
    `chol` [N,9,9]; b, x in the caller's [N, 9] layout. Runs in float32
    (as the reference kernel does) and returns x in b's dtype."""
    M = Hz.shape[0]
    N = b.shape[0]
    if (Hz.dim() != 2 or Hz.shape[1] != M or M % D or M // D < N
            or tuple(b.shape) != (N, D) or tuple(chol.shape) != (N, D, D)):
        raise ValueError(
            f"pcg_dense: needs Hz [9*Nc, 9*Nc] with Nc >= N, b [N, 9], "
            f"chol [N, 9, 9]; got {tuple(Hz.shape)}, {tuple(b.shape)}, "
            f"{tuple(chol.shape)}")
    if not (Hz.device == b.device == chol.device):
        raise ValueError("pcg_dense: inputs on different devices")
    Nc = M // D
    Lp = chol_planes(chol.to(torch.float32), Nc)
    b2 = torch.zeros((D, Nc), dtype=torch.float32, device=b.device)
    b2[:, :N] = b.to(torch.float32).T
    Hz32 = Hz.to(torch.float32).contiguous()
    kw = dict(min_iters=min_num_iterations, max_iters=max_num_iterations,
              q_tol=q_tolerance, r_tol=r_tolerance,
              reset_period=residual_reset_period)
    if Hz.device.type == "cpu":
        x2, stats = pcg_dense_plain(Hz32, b2, Lp, **kw)
    elif Hz.device.type == "cuda":
        x2, stats = _launch(Hz32, b2, Lp, N, **kw)
    else:
        raise ValueError(f"pcg_dense: unsupported device {Hz.device}")
    return CGResult(x=x2[:, :N].T.to(b.dtype),
                    num_iterations=stats[0].to(torch.int32),
                    termination_type=stats[1].to(torch.int32),
                    final_zeta=stats[2], final_norm_r=stats[3])
