"""Fixed-shape time splines for action parameterization.

A fixed number of nodes on a uniform time grid (t0 + k*dt), so sampling is
a gather + blend with no data-dependent shapes. Interpolation semantics
(zero/linear/cubic with finite-difference Hermite slopes, endpoint
clamping) follow the JAX package's spline.py. `fit` and the interpolation
operators arrive with the planners that need them.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Interpolation(enum.IntEnum):
  ZERO = 0
  LINEAR = 1
  CUBIC = 2


@dataclasses.dataclass(frozen=True)
class SplinePolicy:
  """Uniform-grid spline over actions: node k at time t0 + k*dt."""
  t0: torch.Tensor        # scalar
  dt: torch.Tensor        # scalar node spacing
  values: torch.Tensor    # (..., num_nodes, dim)
  interp: int = Interpolation.ZERO

  @property
  def num_nodes(self) -> int:
    return self.values.shape[-2]

  def replace(self, **kw) -> "SplinePolicy":
    return dataclasses.replace(self, **kw)


def _slopes(values: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
  """Finite-difference Hermite slopes: average of adjacent secants inside,
  one-sided at the ends."""
  sec = (values[..., 1:, :] - values[..., :-1, :]) / dt
  first = sec[..., :1, :]
  last = sec[..., -1:, :]
  interior = 0.5 * (sec[..., 1:, :] + sec[..., :-1, :])
  return torch.cat([first, interior, last], dim=-2)


def sample(policy: SplinePolicy, t) -> torch.Tensor:
  """Sample the spline at times t (scalar or (T,)) -> (..., dim) or
  (..., T, dim)."""
  p = policy.num_nodes
  values = policy.values
  t = torch.as_tensor(t, dtype=values.dtype, device=values.device)
  s = (t - policy.t0) / torch.clamp(policy.dt, min=1e-10)
  s = torch.clamp(s, 0.0, p - 1.0)
  if policy.interp == Interpolation.ZERO:
    # zero-order hold may land on the LAST node
    lo_z = torch.clamp(torch.floor(s).long(), 0, p - 1)
    return values.index_select(-2, lo_z.reshape(-1)).reshape(
        values.shape[:-2] + tuple(t.shape) + values.shape[-1:])
  lo = torch.clamp(torch.floor(s).long(), 0, max(p - 2, 0))
  hi = torch.clamp(lo + 1, max=p - 1)
  frac = (s - lo.to(values.dtype)).reshape(tuple(t.shape) + (1,))

  def take(x, idx):
    return x.index_select(-2, idx.reshape(-1)).reshape(
        x.shape[:-2] + tuple(t.shape) + x.shape[-1:])

  v_lo, v_hi = take(values, lo), take(values, hi)
  if policy.interp == Interpolation.LINEAR:
    return v_lo * (1.0 - frac) + v_hi * frac
  slopes = _slopes(values, policy.dt)
  m0, m1 = take(slopes, lo), take(slopes, hi)
  tt = frac
  c0 = 2 * tt**3 - 3 * tt**2 + 1
  c1 = (tt**3 - 2 * tt**2 + tt) * policy.dt
  c2 = -2 * tt**3 + 3 * tt**2
  c3 = (tt**3 - tt**2) * policy.dt
  return c0 * v_lo + c1 * m0 + c2 * v_hi + c3 * m1


def resample(policy: SplinePolicy, new_t0, horizon_time) -> SplinePolicy:
  """Resample onto a fresh uniform grid starting at new_t0: node times
  new_t0 + k*shift with shift = horizon/P (zero-order) or horizon/(P-1)
  (linear/cubic), values sampled from the current spline."""
  p = policy.num_nodes
  values = policy.values
  new_t0 = torch.as_tensor(new_t0, dtype=values.dtype, device=values.device)
  horizon_time = torch.as_tensor(horizon_time, dtype=values.dtype,
                                 device=values.device)
  denom = p if policy.interp == Interpolation.ZERO else max(p - 1, 1)
  shift = torch.clamp(horizon_time / denom, min=1e-5)
  new_times = new_t0 + shift * torch.arange(
      p, dtype=values.dtype, device=values.device)
  return policy.replace(t0=new_t0, dt=shift,
                        values=sample(policy, new_times))


def slide(policy: SplinePolicy, new_t0) -> SplinePolicy:
  """Sliding-plan update: advance the grid by whole nodes so committed
  future nodes are preserved; values roll left and the freed tail repeats
  the last value."""
  p = policy.num_nodes
  values = policy.values
  new_t0 = torch.as_tensor(new_t0, dtype=values.dtype, device=values.device)
  k = torch.clamp(
      torch.floor((new_t0 - policy.t0) / torch.clamp(policy.dt, min=1e-10)),
      0.0, p - 1.0).long()
  idx = torch.clamp(torch.arange(p, device=values.device) + k, max=p - 1)
  return policy.replace(
      t0=policy.t0 + k.to(values.dtype) * policy.dt,
      values=values.index_select(-2, idx))
