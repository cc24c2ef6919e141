"""Residual norms (values only; gradients and Hessians arrive with the
derivative-based planners).

Same norm family and enum values as the JAX package's costs/norms.py, so
task files parse identically.
"""

from __future__ import annotations

import enum

import torch

_EPS = 1e-15


class NormType(enum.IntEnum):
  NULL = -1
  QUADRATIC = 0
  L22 = 1
  L2 = 2
  COSH = 3
  POWER_LOSS = 5
  SMOOTH_ABS = 6
  SMOOTH_ABS2 = 7
  RECTIFY = 8


def num_norm_params(norm_type: int) -> int:
  return {
      NormType.NULL: 0,
      NormType.QUADRATIC: 0,
      NormType.L22: 2,
      NormType.L2: 1,
      NormType.COSH: 1,
      NormType.POWER_LOSS: 1,
      NormType.SMOOTH_ABS: 1,
      NormType.SMOOTH_ABS2: 2,
      NormType.RECTIFY: 1,
  }[NormType(norm_type)]


def norm_value(x: torch.Tensor, norm_type: int,
               params: torch.Tensor) -> torch.Tensor:
  """Norm value; x has shape (..., n), returns (...)."""
  nt = NormType(norm_type)
  zero = torch.zeros((), dtype=x.dtype, device=x.device)
  p = params[0] if params.shape[0] > 0 else zero
  q = params[1] if params.shape[0] > 1 else zero

  if nt == NormType.NULL:
    return x[..., 0]
  if nt == NormType.QUADRATIC:
    return 0.5 * torch.sum(x * x, dim=-1)
  if nt == NormType.L22:
    c = torch.sum(x * x, dim=-1)
    a = torch.pow(torch.clamp(c, min=_EPS), q / 2) + torch.pow(p, q)
    return torch.pow(a, 1.0 / q) - p
  if nt == NormType.L2:
    return torch.sqrt(torch.sum(x * x, dim=-1) + p * p) - p
  if nt == NormType.COSH:
    return torch.sum(p * p * (torch.cosh(x / p) - 1.0), dim=-1)
  if nt == NormType.POWER_LOSS:
    return torch.sum(torch.pow(torch.abs(x), p), dim=-1)
  if nt == NormType.SMOOTH_ABS:
    return torch.sum(torch.sqrt(x * x + p * p) - p, dim=-1)
  if nt == NormType.SMOOTH_ABS2:
    e = torch.pow(torch.abs(x), q) + torch.pow(p, q)
    return torch.sum(torch.pow(e, 1.0 / q) - p, dim=-1)
  if nt == NormType.RECTIFY:
    # p > 0: softplus with temperature p; p == 0: relu
    soft = p * torch.log1p(torch.exp(x / torch.clamp(p, min=_EPS)))
    return torch.sum(torch.where(p > 0, soft, torch.clamp(x, min=0.0)),
                     dim=-1)
  raise ValueError(f"unknown norm {norm_type}")
