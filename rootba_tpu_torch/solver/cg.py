"""Preconditioned conjugate gradients.

Port of the JAX package's `solver/cg.py`: the reference's Ceres-derived
loop (cg/conjugate_gradient.hpp:83-300) -- residual reset every
`residual_reset_period` iterations, rho/beta/alpha breakdown detection,
indefiniteness (p'q <= 0), and the Nash zeta test (zeta = i (Q1-Q0)/Q1 <
q_tolerance) or |r| <= r_tolerance |b|, within min/max iteration bounds.
`lax.while_loop` becomes a Python loop whose only host read per
iteration is the termination code (the span "sync.pcg" of log/trace.py),
plus one read of |b| ("sync.pcg_norm") and one upload ("sync.pcg_setup")
per solve; everything else stays on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from rootba_tpu_torch.log import trace

# termination types (mirror ConjugateGradientsSolver::Summary)
CG_RUNNING = -1
CG_NO_CONVERGENCE = 0
CG_SUCCESS = 1
CG_FAILURE = 2


class CGResult(NamedTuple):
    x: torch.Tensor
    num_iterations: Union[int, torch.Tensor]
    termination_type: Union[int, torch.Tensor]
    final_zeta: torch.Tensor
    final_norm_r: torch.Tensor


def _plain_dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _make_dot(compensated: bool):
    if not compensated:
        return _plain_dot
    from rootba_tpu_torch.ops.compensated import comp_dot

    return comp_dot


def _zero_or_inf(x):
    return (x == 0) | torch.isinf(x)


def pcg(matvec: Callable, precond: Callable, b: torch.Tensor, *,
        min_num_iterations: int = 0, max_num_iterations: int = 500,
        residual_reset_period: int = 10, q_tolerance: float = 0.1,
        r_tolerance: float = -1.0, compensated: bool = False) -> CGResult:
    """Solve H x = b from x0 = 0 (b typically [N, 9]).

    compensated=True computes the rho, p'q and Nash q1 dot products with
    error-free-transform accumulation (ops.compensated.comp_dot)."""
    dtype = b.dtype
    dot = _make_dot(compensated)
    norm_b = torch.linalg.vector_norm(b.reshape(-1))
    tol_r = b.new_full((), r_tolerance) * norm_b
    with trace.sync("pcg_setup"):  # the upload syncs the stream
        running = torch.tensor(CG_RUNNING, device=b.device)

    x = torch.zeros_like(b)
    r = b
    p = b
    rho = b.new_full((), 1.0)
    q0 = b.new_zeros(())
    term = running
    term_h = CG_RUNNING  # the host's copy of term
    i = 0
    while i < max_num_iterations:
        i += 1
        z = precond(r)
        last_rho = rho
        rho = dot(r, z)
        fail_rho = _zero_or_inf(rho)
        beta = rho / torch.where(last_rho == 0, torch.ones_like(last_rho),
                                 last_rho)
        fail_beta = (_zero_or_inf(beta) if i > 1
                     else torch.zeros_like(fail_rho))
        p = z if i == 1 else z + beta.to(dtype) * p

        q = matvec(p)
        pq = dot(p, q)
        indefinite = (pq <= 0) | torch.isinf(pq)
        alpha = rho / torch.where(pq == 0, torch.ones_like(pq), pq)
        fail_alpha = torch.isinf(alpha)

        # the reference breaks *before* applying the update on any of
        # these failures (conjugate_gradient.hpp:140-225); keep x as-is
        failed = fail_rho | fail_beta | fail_alpha
        broken = failed | indefinite
        alpha_eff = torch.where(broken, torch.zeros_like(alpha), alpha)
        x = x + alpha_eff.to(dtype) * p
        # periodic exact residual to fight drift (extra matvec)
        if i % residual_reset_period == 0:
            r = b - matvec(x)
        else:
            r = r - alpha_eff.to(dtype) * q

        q1 = -dot(x, b + r)
        zeta = float(i) * (q1 - q0) / q1
        norm_r = torch.linalg.vector_norm(r.reshape(-1))
        done = (((zeta < q_tolerance) | (norm_r <= tol_r))
                & (i >= min_num_iterations))
        term = torch.where(
            failed, CG_FAILURE,
            torch.where(indefinite, CG_NO_CONVERGENCE,
                        torch.where(done, CG_SUCCESS, running)))
        q0 = q1
        with trace.sync("pcg"):
            term_h = int(term)
        if term_h != CG_RUNNING:
            break

    # |b| == 0 -> success with x = 0 ("Convergence. |b| = 0")
    term = term_h
    with trace.sync("pcg_norm"):
        b_zero = float(norm_b) == 0
    if b_zero:
        term = CG_SUCCESS
        x = torch.zeros_like(x)
    elif term == CG_RUNNING:
        term = CG_NO_CONVERGENCE
    q1 = -dot(x, b + r)
    zeta = float(i) * (q1 - q0) / torch.where(q1 == 0,
                                              torch.ones_like(q1), q1)
    return CGResult(x=x, num_iterations=i, termination_type=term,
                    final_zeta=zeta,
                    final_norm_r=torch.linalg.vector_norm(r.reshape(-1)))
