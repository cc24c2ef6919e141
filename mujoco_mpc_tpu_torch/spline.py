"""Fixed-shape time splines for action parameterization.

A fixed number of nodes on a uniform time grid (t0 + k*dt), so sampling is
a gather + blend with no data-dependent shapes. Interpolation semantics
(zero/linear/cubic with finite-difference Hermite slopes, endpoint
clamping) follow the JAX package's spline.py. `interpolation_matrix` and
`fit` turn an action trajectory back into spline nodes (iLQS).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
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


def slope_matrix(dt, num_nodes: int, dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
  """S with slopes = S @ values: the finite-difference Hermite slope rule
  (_slopes) as a (P, P) linear operator."""
  p = num_nodes
  pattern = np.zeros((p, p), np.float32)
  if p >= 2:
    pattern[0, :2] = (-1.0, 1.0)
    pattern[p - 1, p - 2:] = (-1.0, 1.0)
    for i in range(1, p - 1):
      pattern[i, i - 1], pattern[i, i + 1] = -0.5, 0.5
  inv = 1.0 / torch.clamp(torch.as_tensor(dt, dtype=dtype, device=device),
                          min=1e-10)
  return torch.as_tensor(pattern).to(device=device, dtype=dtype) * inv


def interpolation_matrix(t0, dt, num_nodes: int, times: torch.Tensor,
                         interp: int) -> torch.Tensor:
  """Linear operator M with u(times[i]) = M[i] @ values (per action dim):
  all three interpolations are exactly linear in the node values (cubic
  because the Hermite slopes are, `slope_matrix`)."""
  p = num_nodes
  dtype, dev = times.dtype, times.device
  s = (times - t0) / torch.clamp(torch.as_tensor(dt, dtype=dtype,
                                                 device=dev), min=1e-10)
  s = torch.clamp(s, 0.0, p - 1.0)
  cols = torch.arange(p, device=dev)[None, :]
  if interp == Interpolation.ZERO:
    # zero-order hold may land on the LAST node (sample() semantics)
    lo_z = torch.clamp(torch.floor(s).long(), 0, p - 1)
    return (cols == lo_z[:, None]).to(dtype)
  lo = torch.clamp(torch.floor(s).long(), 0, max(p - 2, 0))
  hi = torch.clamp(lo + 1, max=p - 1)
  frac = s - lo.to(dtype)
  e_lo = (cols == lo[:, None]).to(dtype)
  e_hi = (cols == hi[:, None]).to(dtype)
  if interp == Interpolation.LINEAR or p < 2:
    return e_lo * (1.0 - frac)[:, None] + e_hi * frac[:, None]
  tt = frac
  c0 = 2 * tt**3 - 3 * tt**2 + 1
  c1 = (tt**3 - 2 * tt**2 + tt) * dt
  c2 = -2 * tt**3 + 3 * tt**2
  c3 = (tt**3 - tt**2) * dt
  smat = slope_matrix(dt, p, dtype, dev)
  return (e_lo * c0[:, None] + e_hi * c2[:, None] +
          c1[:, None] * smat.index_select(0, lo) +
          c3[:, None] * smat.index_select(0, hi))


def fit(actions: torch.Tensor, times: torch.Tensor, t0, dt, num_nodes: int,
        interp: int) -> torch.Tensor:
  """Least-squares spline nodes fitting u(times) ~= actions (T, nu): the
  regularised normal equations, solved by the library (one small solve an
  iLQS switch, as the JAX package leaves it to its array library)."""
  m = interpolation_matrix(t0, dt, num_nodes, times, interp)
  a = m.T @ m + 1e-6 * torch.eye(num_nodes, dtype=actions.dtype,
                                 device=actions.device)
  # solve_ex: no status check, so no read-back from the device
  return torch.linalg.solve_ex(a, m.T @ actions).result
