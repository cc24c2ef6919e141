"""Trajectory rollouts on the pipeline physics: one policy from one state
(`rollout`, `noisy_rollout`) and the batched form the sampling planners use
(`make_batched_returns`: vmapped over candidates, scored by ONE launch of
the fused scoring kernel, the SPD solves of every step through the batched
Cholesky kernel).

Semantics (those of the JAX package's rollout.py, which follows
mjpc/trajectory.cc):
  * action sampled from the policy at the pre-step time and clipped to the
    control range, held for the step;
  * residual evaluated on the PRE-integration state of each step (forward,
    record the residual, then integrate): residuals[t] aligns with
    states[t];
  * a final forward pass produces the last residual; the last action
    duplicates the one before it;
  * divergence (non-finite or > 1e7 state) poisons the rollout:
    total_return = 1e6;
  * total_return = sum(costs) / horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.ops import scoring
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.physics.model import Data, Model

MAX_RETURN_VALUE = 1e6


@dataclasses.dataclass(frozen=True)
class Trajectory:
  """Rollout record."""
  states: torch.Tensor        # (T, nq+nv+na)
  actions: torch.Tensor       # (T, nu)
  times: torch.Tensor         # (T,)
  residuals: torch.Tensor     # (T, num_residual)
  costs: torch.Tensor         # (T,)
  total_return: torch.Tensor  # scalar
  failure: torch.Tensor       # bool

# the TRUE dynamic state of a rollout: everything else in Data is derived
# and recomputed every step
_CARRY_FIELDS = ("qpos", "qvel", "act", "ctrl", "time", "mocap_pos",
                 "mocap_quat", "userdata", "qfrc_applied", "xfrc_applied")


def pack_state(d: Data) -> torch.Tensor:
  """[qpos, qvel, act] packing."""
  return torch.cat([d.qpos, d.qvel, d.act])


def slim_carry(d: Data) -> dict:
  return {f: getattr(d, f) for f in _CARRY_FIELDS}


def from_carry(carry: dict) -> Data:
  return Data(**carry)


def set_state(m: Model, d: Data, state: torch.Tensor) -> Data:
  nq, nv, na = m.nq, m.nv, m.na
  return d.replace(qpos=state[:nq], qvel=state[nq:nq + nv],
                   act=state[nq + nv:nq + nv + na])


def _diverged(d: Data) -> torch.Tensor:
  bad = ~torch.isfinite(d.qpos).all() | ~torch.isfinite(d.qvel).all()
  big = (torch.abs(d.qvel).amax() > 1e7) | (torch.abs(d.qpos).amax() > 1e7)
  return bad | big


def ou_rate_scale(m: Model, xfrc_std, xfrc_rate):
  """Ornstein-Uhlenbeck body-wrench noise per step: xfrc <- rate * xfrc +
  scale * N(0, 1), rate = exp(-timestep / xfrc_rate), scale = std *
  sqrt(1 - rate^2)."""
  dtype, dev = m.opt.timestep.dtype, m.opt.timestep.device
  std = torch.as_tensor(xfrc_std, dtype=dtype, device=dev)
  tau = torch.as_tensor(xfrc_rate, dtype=dtype, device=dev)
  rate = torch.exp(-m.opt.timestep / torch.clamp(tau, min=1e-8))
  scale = std * torch.sqrt(torch.clamp(1.0 - rate * rate, min=0.0))
  return rate, scale


def _steps(m: Model, residual_fn, policy_fn, d0: Data, horizon: int,
           xfrc_noise=None, rate=None, scale=None):
  """The horizon on one Data: (states, actions, times, residuals) stacked
  over T = horizon steps, and the failure flag. With `xfrc_noise`
  (horizon-1, nbody, 6) the body wrench follows the OU recursion."""
  lo = m.actuator_ctrlrange[:, 0]
  hi = m.actuator_ctrlrange[:, 1]
  d = from_carry(slim_carry(d0))
  states, actions, times, residuals, fails = [], [], [], [], []
  for t in range(horizon - 1):
    state = pack_state(d)
    u = torch.minimum(torch.maximum(policy_fn(state, d.time), lo), hi)
    if xfrc_noise is not None:
      d = d.replace(xfrc_applied=rate * d.xfrc_applied +
                    scale * xfrc_noise[t])
    d = F.forward(m, d.replace(ctrl=u))
    residuals.append(residual_fn(m, d))   # pre-integration
    times.append(d.time)
    d = from_carry(slim_carry(F.integrate(m, d)))
    states.append(state)
    actions.append(u)
    fails.append(_diverged(d))
  d_final = F.forward(m, d)
  states.append(pack_state(d_final))
  actions.append(actions[-1])
  times.append(d_final.time + 0)
  residuals.append(residual_fn(m, d_final))
  failure = torch.stack(fails).any() | _diverged(d_final)
  return (torch.stack(states), torch.stack(actions), torch.stack(times),
          torch.stack(residuals), failure)


def _trajectory(horizon, cost_fn, states, actions, times, residuals,
                failure) -> Trajectory:
  costs = cost_fn(residuals)
  failure = failure | ~torch.isfinite(costs).all()
  poison = torch.full_like(costs, MAX_RETURN_VALUE)
  total = torch.where(failure, poison[0], torch.sum(costs) / max(horizon, 1))
  return Trajectory(states=states, actions=actions, times=times,
                    residuals=residuals,
                    costs=torch.where(failure, poison, costs),
                    total_return=total, failure=failure)


def rollout(m: Model, residual_fn: Callable, cost_fn: Callable,
            policy_fn: Callable, d0: Data, horizon: int) -> Trajectory:
  """Roll out a policy for `horizon` steps from d0. policy_fn(state, time)
  -> action (clipped here to the control range)."""
  return _trajectory(horizon, cost_fn,
                     *_steps(m, residual_fn, policy_fn, d0, horizon))


def noisy_rollout(m: Model, residual_fn: Callable, cost_fn: Callable,
                  policy_fn: Callable, d0: Data, horizon: int,
                  gen: Optional[torch.Generator], xfrc_std, xfrc_rate,
                  noise: Optional[torch.Tensor] = None) -> Trajectory:
  """Rollout under Ornstein-Uhlenbeck body-wrench perturbations (the
  Robust planner's re-rolls). The standard normals of the H-1 steps come
  from `gen`, or pre-drawn as `noise` (horizon-1, nbody, 6)."""
  rate, scale = ou_rate_scale(m, xfrc_std, xfrc_rate)
  if noise is None:
    noise = torch.randn((horizon - 1,) + tuple(d0.xfrc_applied.shape),
                        generator=gen, dtype=d0.xfrc_applied.dtype,
                        device=d0.xfrc_applied.device)
  return _trajectory(horizon, cost_fn, *_steps(
      m, residual_fn, policy_fn, d0, horizon, noise, rate, scale))


def make_batched_returns(m: Model, residual_fn: Callable, cost_spec,
                         horizon: int, interp: int, xfrc_std=None,
                         xfrc_rate=None):
  """Batched spline rollouts on the pipeline physics.

  Returns `fn(values (B, P, nu), t0, dt, d0, cost_spec=None, noise=None,
  residual_fn=None) -> (returns (B,), failure (B,), residuals (B, T, nr))`:
  candidate b holds the spline nodes values[b] on the grid t0 + k dt;
  `cost_spec` / `residual_fn` at call time replace the build-time ones (same
  cost terms). The B rollouts run as
  one `torch.func.vmap` over `rollout`'s step loop, with every SPD solve of
  every step through the batched Cholesky kernel (one launch for the batch;
  `m.solve_route` is set to "kernel" here); the returns then come from one
  launch of the fused scoring kernel outside the vmap (ops/scoring.py; its
  gate as in `make_scorer`). With `xfrc_std` the
  rollouts are noisy (`noisy_rollout`): `noise` (B, horizon-1, nbody, 6)
  standard normals, one set per candidate. Raises NotImplementedError,
  naming what is missing, for a model the pipeline physics cannot step.
  `fn.routes` says which route scoring and solves take."""
  F.check_supported(m)
  mk = m.replace(solve_route=S.SOLVE_KERNEL)
  scorer = scoring.make_scorer(cost_spec, m.qpos0.device)
  residual_fn0 = residual_fn
  noisy = xfrc_std is not None
  rate = scale = None
  if noisy:
    rate, scale = ou_rate_scale(mk, xfrc_std, xfrc_rate)

  def fn(values, t0, dt, d0, cost_spec=None, noise=None, residual_fn=None):
    rf = residual_fn if residual_fn is not None else residual_fn0

    def one(v, nz):
      pol = spline_lib.SplinePolicy(t0=t0, dt=dt, values=v, interp=interp)
      out = _steps(mk, rf,
                   lambda state, time: spline_lib.sample(pol, time), d0,
                   horizon, nz, rate, scale)
      return out[3], out[4]

    if noisy:
      if noise is None:
        raise ValueError("noisy batched rollouts need their noise")
      residuals, failure = torch.func.vmap(one)(values, noise)
    else:
      residuals, failure = torch.func.vmap(lambda v: one(v, None))(values)
    returns = scorer(residuals.permute(1, 2, 0), cost_spec)
    failure = failure | ~torch.isfinite(returns)
    returns = torch.where(failure, torch.full_like(returns, MAX_RETURN_VALUE),
                          returns)
    return returns, failure, residuals

  fn.routes = dict(rollouts="pipeline", spd_solve=S.SOLVE_KERNEL,
                   scoring=scorer.route)
  fn.scorer = scorer
  return fn
