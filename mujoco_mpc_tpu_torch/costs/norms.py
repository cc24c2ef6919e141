"""Residual norms: values, analytic gradients and Hessians (the
Gauss-Newton cost expansion of the derivative-based planners).

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
  p, q = _pq(x, params)

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


def _pq(x, params):
  zero = torch.zeros((), dtype=x.dtype, device=x.device)
  p = params[0] if params.shape[0] > 0 else zero
  q = params[1] if params.shape[0] > 1 else zero
  return p, q


def norm_grad(x: torch.Tensor, norm_type: int,
              params: torch.Tensor) -> torch.Tensor:
  """Analytic gradient dy/dx, shape (..., n)."""
  nt = NormType(norm_type)
  p, q = _pq(x, params)

  if nt == NormType.NULL:
    return torch.ones_like(x)
  if nt == NormType.QUADRATIC:
    return x
  if nt == NormType.L22:
    c = torch.sum(x * x, dim=-1, keepdim=True)
    cc = torch.clamp(c, min=_EPS)
    a = torch.pow(cc, q / 2) + torch.pow(p, q)
    s = torch.pow(a, 1.0 / q)
    b = s / a * torch.pow(cc, q / 2 - 1.0)
    return b * x
  if nt == NormType.L2:
    s = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + p * p)
    return x / torch.clamp(s, min=_EPS)
  if nt == NormType.COSH:
    return p * torch.sinh(x / p)
  if nt == NormType.POWER_LOSS:
    a = torch.clamp(torch.abs(x), min=_EPS)
    return torch.sign(x) * p * torch.pow(a, p - 1.0)
  if nt == NormType.SMOOTH_ABS:
    s = torch.sqrt(x * x + p * p)
    return x / torch.clamp(s, min=_EPS)
  if nt == NormType.SMOOTH_ABS2:
    a = torch.clamp(torch.abs(x), min=_EPS)
    dd = torch.pow(a, q)
    e = dd + torch.pow(p, q)
    s = torch.pow(e, 1.0 / q)
    c = s * torch.pow(a, q - 2.0) / e
    return c * x
  if nt == NormType.RECTIFY:
    s = torch.exp(x / torch.clamp(p, min=_EPS))
    return torch.where(p > 0, s / (1.0 + s), (x > 0).to(x.dtype))
  raise ValueError(f"unknown norm {norm_type}")


def norm_hess_diag(x: torch.Tensor, norm_type: int,
                   params: torch.Tensor) -> torch.Tensor:
  """Hessian for the Gauss-Newton cost expansion.

  Most norms have diagonal Hessians; L2/L22 have rank-1 structure — the
  full (..., n, n) matrix is returned for uniformity.
  """
  nt = NormType(norm_type)
  n = x.shape[-1]
  p, q = _pq(x, params)
  eye = torch.eye(n, dtype=x.dtype, device=x.device)

  def diag(v):
    return v[..., :, None] * eye

  if nt == NormType.NULL:
    return torch.zeros(x.shape + (n,), dtype=x.dtype, device=x.device)
  if nt == NormType.QUADRATIC:
    return eye.expand(x.shape + (n,))
  if nt == NormType.L22:
    c = torch.sum(x * x, dim=-1, keepdim=True)
    cc = torch.clamp(c, min=_EPS)
    d = torch.pow(cc, q / 2 - 1.0)
    a = torch.pow(cc, q / 2) + torch.pow(p, q)
    s = torch.pow(a, 1.0 / q)
    b = s / a * d
    coef = (1.0 - q) * d / a + (q - 2.0) / cc
    outer = x[..., :, None] * x[..., None, :]
    return b[..., None] * (eye + outer * coef[..., None])
  if nt == NormType.L2:
    s = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + p * p)
    g = x / torch.clamp(s, min=_EPS)
    outer = g[..., :, None] * g[..., None, :]
    return (eye - outer) / torch.clamp(s[..., None], min=_EPS)
  if nt == NormType.COSH:
    return diag(torch.cosh(x / p))
  if nt == NormType.POWER_LOSS:
    a = torch.clamp(torch.abs(x), min=_EPS)
    return diag((p - 1.0) * p * torch.pow(a, p - 2.0))
  if nt == NormType.SMOOTH_ABS:
    s = torch.sqrt(x * x + p * p)
    g = x / torch.clamp(s, min=_EPS)
    return diag((1.0 - g * g) / torch.clamp(s, min=_EPS))
  if nt == NormType.SMOOTH_ABS2:
    a = torch.clamp(torch.abs(x), min=_EPS)
    dd = torch.pow(a, q)
    e = dd + torch.pow(p, q)
    s = torch.pow(e, 1.0 / q)
    c = s * torch.pow(a, q - 2.0) / e
    return diag(c * (q - 1.0) * (1.0 - dd / e))
  if nt == NormType.RECTIFY:
    s = torch.exp(x / torch.clamp(p, min=_EPS))
    h = torch.where(p > 0, s / (torch.clamp(p, min=_EPS) * (1 + s) ** 2),
                    torch.zeros_like(x))
    return diag(h)
  raise ValueError(f"unknown norm {norm_type}")
