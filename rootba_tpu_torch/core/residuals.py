"""Robust weighting and whole-problem cost accounting.

Port of the JAX package's `core/residuals.py`:
  * compute_error_weight -- reference bal_bundle_adjustment_helper.cpp
    :45-65 (Huber: cost = 0.5 (2-w) w r^2 with w = thresh/|r| beyond the
    threshold);
  * the ResidualInfo 'all' vs 'valid' split -- residual_info.cpp:97-124.

Costs accumulate in float64 in every solver precision, as the JAX
package does with x64 enabled: the accept/reject test reads their
differences.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rootba_tpu_torch.log import trace

ROBUST_NORM_NONE = 0
ROBUST_NORM_HUBER = 1

ACC_DTYPE = torch.float64


def compute_error_weight(res_squared: torch.Tensor, robust_norm: int,
                         huber_parameter: float):
    """(weighted_error, weight), elementwise."""
    if robust_norm == ROBUST_NORM_NONE:
        return 0.5 * res_squared, torch.ones_like(res_squared)
    thresh = res_squared.new_full((), huber_parameter)
    r = torch.sqrt(torch.clamp(res_squared,
                               min=torch.finfo(res_squared.dtype).tiny))
    weight = torch.where(res_squared < thresh * thresh,
                         torch.ones_like(r), thresh / r)
    error = 0.5 * (2.0 - weight) * weight * res_squared
    return error, weight


class ResidualItem(NamedTuple):
    num_obs: torch.Tensor  # int64 0-d
    error: torch.Tensor  # sum of robustified 0.5 r^2
    residual_sum: torch.Tensor  # sum of ||r||


class ResidualInfo(NamedTuple):
    """Cost split into all vs valid (positive-z) residual sets."""

    all: ResidualItem
    valid: ResidualItem
    is_numerically_valid: torch.Tensor  # bool 0-d


def accumulate_residual_info(res: torch.Tensor, proj_valid: torch.Tensor,
                             obs_mask: torch.Tensor, robust_norm: int,
                             huber_parameter: float) -> ResidualInfo:
    """ResidualInfoAccu::add over every real (non-padded) observation;
    res [..., 2], proj_valid / obs_mask [...] bool."""
    res_squared = torch.sum(res * res, dim=-1)
    weighted_error, _ = compute_error_weight(res_squared, robust_norm,
                                             huber_parameter)
    res_norm = torch.sqrt(res_squared)
    numerically_valid = torch.all(
        torch.where(obs_mask[..., None], torch.isfinite(res), True))
    maskf = obs_mask.to(ACC_DTYPE)
    vmaskf = (obs_mask & proj_valid).to(ACC_DTYPE)

    def item(m):
        return ResidualItem(
            num_obs=torch.sum(m).to(torch.int64),
            error=torch.sum(weighted_error.to(ACC_DTYPE) * m),
            residual_sum=torch.sum(res_norm.to(ACC_DTYPE) * m))

    return ResidualInfo(all=item(maskf), valid=item(vmaskf),
                        is_numerically_valid=numerically_valid)


def join_residual_info(a: ResidualInfo, b: ResidualInfo) -> ResidualInfo:
    def join_item(x: ResidualItem, y: ResidualItem):
        return ResidualItem(num_obs=x.num_obs + y.num_obs,
                            error=x.error + y.error,
                            residual_sum=x.residual_sum + y.residual_sum)

    return ResidualInfo(
        all=join_item(a.all, b.all), valid=join_item(a.valid, b.valid),
        is_numerically_valid=(a.is_numerically_valid
                              & b.is_numerically_valid))


def empty_residual_info(device) -> ResidualInfo:
    zero = torch.zeros((), dtype=ACC_DTYPE, device=device)
    izero = torch.zeros((), dtype=torch.int64, device=device)
    item = ResidualItem(num_obs=izero, error=zero, residual_sum=zero)
    return ResidualInfo(all=item, valid=item,
                        is_numerically_valid=torch.ones(
                            (), dtype=torch.bool, device=device))


def residual_info_vector(info: ResidualInfo) -> torch.Tensor:
    """The seven fields of `info` as one float64 vector, for a single
    device->host transfer (residual_info_from_values reads it back).
    Counts are exact in float64 below 2**53."""
    return torch.stack([
        info.all.num_obs.to(ACC_DTYPE), info.all.error,
        info.all.residual_sum, info.valid.num_obs.to(ACC_DTYPE),
        info.valid.error, info.valid.residual_sum,
        info.is_numerically_valid.to(ACC_DTYPE)])


def residual_info_from_values(v):
    """The log summary's ResidualInfoHost from the seven host floats of
    residual_info_vector."""
    from rootba_tpu_torch.log.summary import (
        ResidualInfoHost,
        ResidualItemHost,
    )

    return ResidualInfoHost(
        all=ResidualItemHost(num_obs=int(v[0]), error=v[1],
                             residual_sum=v[2]),
        valid=ResidualItemHost(num_obs=int(v[3]), error=v[4],
                               residual_sum=v[5]),
        is_numerically_valid=bool(v[6]))


def residual_info_to_host(info: ResidualInfo):
    """One device->host transfer of all seven fields (the log summary's
    ResidualInfoHost)."""
    vec = residual_info_vector(info)
    with trace.sync("cost"):
        values = vec.tolist()
    return residual_info_from_values(values)
