"""Model and cost derivatives along a trajectory.

  * dynamics Jacobians A = df/dx, B = df/du come from forward-mode AD
    (`torch.func.jacfwd`) through the full step function in the
    quaternion-aware tangent space — exact to machine precision, vmapped
    over all timesteps at once;
  * cost expansions are Gauss-Newton: residual Jacobians (AD) chained with
    analytic norm gradients/Hessians (costs/norms.py).

Tangent state dx has dimension ndx = 2*nv + na: [dq (nv), dv (nv), da (na)],
with dq applied through mj_integratePos semantics (quaternion tangent).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import jacfwd, vmap

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics.model import BALL, FREE, Data, Model


def ndx(m: Model) -> int:
  return 2 * m.nv + m.na


def qpos_add(m: Model, qpos: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
  """qpos tangent update (mj_integratePos with dt=1)."""
  return F._integrate_pos(m, qpos, dq, 1.0)


def qpos_diff(m: Model, qpos2: torch.Tensor, qpos1: torch.Tensor
              ) -> torch.Tensor:
  """Tangent difference dq s.t. qpos1 (+) dq ~= qpos2
  (mj_differentiatePos)."""
  if not np.any((m.jnt_type == FREE) | (m.jnt_type == BALL)):
    return qpos2 - qpos1
  parts = []
  for j in range(m.njnt):
    jtype, qa = int(m.jnt_type[j]), int(m.jnt_qposadr[j])
    if jtype == FREE:
      parts.append(qpos2[..., qa:qa + 3] - qpos1[..., qa:qa + 3])
      qa += 3
    if jtype in (FREE, BALL):
      parts.append(mm.quat_sub(mm.normalize_quat(qpos2[..., qa:qa + 4]),
                               mm.normalize_quat(qpos1[..., qa:qa + 4])))
    else:
      parts.append(qpos2[..., qa:qa + 1] - qpos1[..., qa:qa + 1])
  return torch.cat(parts, dim=-1)


def state_add(m: Model, state: torch.Tensor, dx: torch.Tensor
              ) -> torch.Tensor:
  """state [qpos,qvel,act] (+) tangent dx [dq,dv,da]."""
  nq, nv = m.nq, m.nv
  qpos = qpos_add(m, state[:nq], dx[:nv])
  qvel = state[nq:nq + nv] + dx[nv:2 * nv]
  act = state[nq + nv:] + dx[2 * nv:]
  return torch.cat([qpos, qvel, act])


def state_diff(m: Model, s2: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
  """Tangent difference of packed states; leading batch axes broadcast."""
  nq, nv = m.nq, m.nv
  dq = qpos_diff(m, s2[..., :nq], s1[..., :nq])
  dv = s2[..., nq:nq + nv] - s1[..., nq:nq + nv]
  da = s2[..., nq + nv:] - s1[..., nq + nv:]
  return torch.cat([dq, dv, da], dim=-1)


def make_step_fn(m: Model, template: Data) -> Callable:
  """(state, action, time) -> next packed state, via the full pipeline."""

  def step_fn(state, action, time):
    d = rollout_lib.set_state(m, template, state)
    d = F.step(m, d.replace(ctrl=action, time=time))
    return rollout_lib.pack_state(d)

  return step_fn


def _skip_plan(t_hor: int, skip: int):
  """Evaluation indices and, per step, the two neighbours with their
  linear-interpolation weights (the derivative-skip schedule)."""
  eval_idx = np.arange(0, t_hor, skip)
  if eval_idx[-1] != t_hor - 1:
    eval_idx = np.append(eval_idx, t_hor - 1)
  seg_lo, w_hi = [], []
  for t in range(t_hor):
    seg = int(np.searchsorted(eval_idx, t, side="right")) - 1
    seg = min(seg, len(eval_idx) - 2)
    t0, t1 = eval_idx[seg], eval_idx[seg + 1]
    seg_lo.append(seg)
    w_hi.append((t - t0) / max(t1 - t0, 1))
  return eval_idx, np.asarray(seg_lo), np.asarray(w_hi)


def _interpolate(x_e, seg_lo, w_hi):
  w = torch.as_tensor(w_hi, dtype=x_e.dtype, device=x_e.device)
  w = w.reshape((-1,) + (1,) * (x_e.ndim - 1))
  return (1.0 - w) * x_e[seg_lo] + w * x_e[seg_lo + 1]


def model_derivatives(m: Model, template: Data, states: torch.Tensor,
                      actions: torch.Tensor, times: torch.Tensor,
                      skip: int = 1):
  """A (T, ndx, ndx), B (T, ndx, nu) along a trajectory. `skip` > 1
  evaluates every skip-th step and linearly interpolates between."""
  step_fn = make_step_fn(m, template)
  nx = ndx(m)

  def tangent_step(state, action, time):
    nxt0 = step_fn(state, action, time)

    def f(dxu):
      nxt = step_fn(state_add(m, state, dxu[:nx]), action + dxu[nx:], time)
      return state_diff(m, nxt, nxt0)

    jac = jacfwd(f)(torch.zeros(nx + m.nu, dtype=states.dtype,
                                device=states.device))
    return jac[:, :nx], jac[:, nx:]

  t_hor = states.shape[0]
  if skip <= 1 or t_hor <= skip:
    return vmap(tangent_step)(states, actions, times)
  eval_idx, seg_lo, w_hi = _skip_plan(t_hor, skip)
  a_e, b_e = vmap(tangent_step)(states[eval_idx], actions[eval_idx],
                                times[eval_idx])
  return _interpolate(a_e, seg_lo, w_hi), _interpolate(b_e, seg_lo, w_hi)


def trajectory_derivatives(m: Model, template: Data, residual_fn: Callable,
                           cost_spec, states: torch.Tensor,
                           actions: torch.Tensor, times: torch.Tensor,
                           skip: int = 1):
  """Fused model + cost derivatives along a trajectory in ONE AD sweep.

  Dynamics Jacobians and the Gauss-Newton cost expansion need the same
  forward pipeline at (state, action, time): one jacfwd produces
  [state_diff(next); residual] rows (the residual is evaluated
  pre-integration).

  Returns (a, b, cx, cu, cxx, cxu, cuu) with a, b of length T-1 and the
  cost expansions of length T. `skip` > 1 evaluates the Jacobian sweep
  (dynamics AND residual rows) every skip-th step and linearly interpolates
  between; residual VALUES are exact at every step.
  """
  nx = ndx(m)
  zero = torch.zeros(nx + m.nu, dtype=states.dtype, device=states.device)

  def fwd_next_res(state, action, time):
    d = rollout_lib.set_state(m, template, state)
    d = F.forward(m, d.replace(ctrl=action, time=time))
    r = residual_fn(m, d)
    return rollout_lib.pack_state(F.integrate(m, d)), r

  def jac_at(state, action, time):
    nxt0, r0 = fwd_next_res(state, action, time)

    def f(dxu):
      nxt, r = fwd_next_res(state_add(m, state, dxu[:nx]),
                            action + dxu[nx:], time)
      return torch.cat([state_diff(m, nxt, nxt0), r])

    # (nx+nr, nx+nu); a residual that stacks zero-dimensional tensors can
    # come back promoted to float64 under vmap of jacfwd: cast it back
    jac = jacfwd(f)(zero).to(zero.dtype)
    return (jac[:nx, :nx], jac[:nx, nx:],     # a, b
            jac[nx:, :nx], jac[nx:, nx:], r0.to(zero.dtype))  # rx, ru, r0

  def gn(r0, rx, ru):
    g, h = cost_spec.cost_grad_hess(r0)
    rxt, rut = rx.transpose(-1, -2), ru.transpose(-1, -2)
    hrx = h @ rx
    hru = h @ ru
    return ((rxt @ g[..., None])[..., 0], (rut @ g[..., None])[..., 0],
            rxt @ hrx, rxt @ hru, rut @ hru)

  t_hor = states.shape[0]
  if skip <= 1 or t_hor <= skip:
    a, b, rx, ru, r0s = vmap(jac_at)(states, actions, times)
  else:
    eval_idx, seg_lo, w_hi = _skip_plan(t_hor, skip)
    a_e, b_e, rx_e, ru_e, _ = vmap(jac_at)(
        states[eval_idx], actions[eval_idx], times[eval_idx])
    r0s = vmap(lambda s, u, t: fwd_next_res(s, u, t)[1])(
        states, actions, times).to(zero.dtype)
    a, b, rx, ru = (_interpolate(x, seg_lo, w_hi)
                    for x in (a_e, b_e, rx_e, ru_e))
  cx, cu, cxx, cxu, cuu = gn(r0s, rx, ru)
  return a[:-1], b[:-1], cx, cu, cxx, cxu, cuu


def make_residual_at_fn(m: Model, template: Data, residual_fn: Callable):
  """residual evaluated at (state, action, time) after a forward pass."""

  def res_at(state, action, time):
    d = rollout_lib.set_state(m, template, state)
    return residual_fn(m, F.forward(m, d.replace(ctrl=action, time=time)))

  return res_at


def cost_derivatives(m: Model, template: Data, residual_fn: Callable,
                     cost_spec, states: torch.Tensor, actions: torch.Tensor,
                     times: torch.Tensor):
  """Gauss-Newton stage-cost expansion along a trajectory: cx (T, ndx),
  cu (T, nu), cxx (T, ndx, ndx), cxu (T, ndx, nu), cuu (T, nu, nu)."""
  res_at = make_residual_at_fn(m, template, residual_fn)
  nx = ndx(m)
  zero = torch.zeros(nx + m.nu, dtype=states.dtype, device=states.device)

  def expand(state, action, time):
    def r_of(dxu):
      return res_at(state_add(m, state, dxu[:nx]), action + dxu[nx:], time)

    return r_of(zero).to(zero.dtype), jacfwd(r_of)(zero).to(zero.dtype)

  r0, jac = vmap(expand)(states, actions, times)
  rx, ru = jac[..., :nx], jac[..., nx:]
  g, h = cost_spec.cost_grad_hess(r0)
  rxt, rut = rx.transpose(-1, -2), ru.transpose(-1, -2)
  hrx, hru = h @ rx, h @ ru
  return ((rxt @ g[..., None])[..., 0], (rut @ g[..., None])[..., 0],
          rxt @ hrx, rxt @ hru, rut @ hru)
