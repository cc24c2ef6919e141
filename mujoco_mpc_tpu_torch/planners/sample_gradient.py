"""Sample-Gradient planner.

Semantics (those of the JAX package's planners/sample_gradient.py, which
follows mjpc/planners/sample_gradient/): a search gradient from ranked
noisy-sample returns with NES fitness shaping (weights max(0, log(K/2+1) -
log(rank)) normalised, minus 1/K), low-pass filtered against the previous
gradient, and candidates along the negative gradient at log-spaced step
sizes scaled by 1/exploration; the winner of noisy and gradient candidates
becomes the policy. As in the JAX package, the gradient candidates are
scored in the same iteration.

Two scorer calls an iteration, of different K (the noisy set, then the
`num_gradient` candidates): on the lane route both go to the same build of
the rollout kernel, which takes K at call time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.physics.model import Model, check_device
from mujoco_mpc_tpu_torch.planners import sampling


@dataclasses.dataclass(frozen=True)
class SampleGradientConfig:
  num_trajectory: int = 16
  num_gradient: int = 4
  num_spline_points: int = 10
  interp: int = spline_lib.Interpolation.ZERO
  exploration: float = 0.1
  gradient_filter: float = 1.0
  max_step: float = 1.0
  min_step: float = 1e-3
  horizon: int = 100

  def replace(self, **kw) -> "SampleGradientConfig":
    return dataclasses.replace(self, **kw)


def make_config(task) -> SampleGradientConfig:
  horizon_time = task.config("agent_horizon", 1.0)
  agent_timestep = task.config("agent_timestep",
                               float(task.model.opt.timestep))
  k = int(task.config("sampling_trajectories", 16))
  return SampleGradientConfig(
      num_trajectory=k,
      num_gradient=min(int(task.config("num_gradient", 4)), k - 1),
      num_spline_points=int(task.config("sampling_spline_points", 10)),
      exploration=float(task.config("sampling_exploration", 0.1)),
      gradient_filter=float(task.config("gradient_filter", 1.0)),
      horizon=int(round(horizon_time / agent_timestep)) + 1)


@dataclasses.dataclass(frozen=True)
class SGState:
  policy: spline_lib.SplinePolicy
  gradient: torch.Tensor  # (P, nu) filtered search gradient


def initial_state(m: Model, config: SampleGradientConfig,
                  device="cuda") -> SGState:
  p = config.num_spline_points
  ctrlrange = m.actuator_ctrlrange.to(device)
  mid = 0.5 * (ctrlrange[:, 0] + ctrlrange[:, 1])
  f32 = dict(dtype=torch.float32, device=device)
  policy = spline_lib.SplinePolicy(
      t0=torch.zeros((), **f32), dt=torch.tensor(0.1, **f32),
      values=mid[None].repeat(p, 1).to(torch.float32), interp=config.interp)
  return SGState(policy=policy, gradient=torch.zeros((p, m.nu), **f32))


def fitness_weights(num_noisy: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
  """NES utility weights by rank (best rank 0)."""
  ranks = torch.arange(num_noisy, dtype=dtype, device=device)
  f0 = float(np.log(0.5 * num_noisy + 1.0))
  raw = torch.clamp(f0 - torch.log(ranks + 1.0), min=0.0)
  return raw / torch.sum(raw) - 1.0 / num_noisy


def make_optimize_fn(m: Model, residual_fn, cost_spec,
                     config: SampleGradientConfig,
                     residual_fn_with_params=None, returns_fn=None):
  """Returns `optimize(gen, d0, state, residual_params=None, cost_spec=None,
  noise=None) -> (new_state, info)`; `noise` (K_noisy-1, P, nu) standard
  normals may be given pre-drawn. `returns_fn(candidates, d0,
  residual_params, cost_spec)` scores a batch in one call (the lane
  kernel); without it the batched pipeline rollouts do."""
  horizon = config.horizon
  n_grad = config.num_gradient
  n_noisy = config.num_trajectory - n_grad
  batched = None
  if returns_fn is None:
    batched = rollout_lib.make_batched_returns(
        m, residual_fn, cost_spec, horizon, config.interp)

  def optimize(gen, d0, state: SGState, residual_params=None,
               cost_spec=None, noise=None):
    horizon_time = (horizon - 1) * m.opt.timestep
    policy = spline_lib.resample(state.policy, d0.time, horizon_time)
    values = policy.values
    dtype, dev = values.dtype, values.device
    rf = residual_fn
    if residual_params is not None and residual_fn_with_params is not None:
      rf = lambda mm, dd: residual_fn_with_params(mm, dd, residual_params)

    def score(cands):
      if returns_fn is not None:
        return returns_fn(cands, d0, residual_params, cost_spec)
      return batched(cands, policy.t0, policy.dt, d0, cost_spec,
                     residual_fn=rf)[0]

    ctrlrange = m.actuator_ctrlrange.to(dev)
    scale = 0.5 * (ctrlrange[:, 1] - ctrlrange[:, 0])
    if noise is None:
      noise = torch.randn((n_noisy - 1,) + tuple(values.shape),
                          generator=gen, dtype=dtype, device=dev)
    noise = noise * scale[None, None, :] * config.exploration
    noisy_vals = sampling.clip_ctrl(m, values[None] + noise)
    noisy_all = torch.cat([values[None], noisy_vals], dim=0)
    noisy_rets = score(noisy_all)

    # fitness-shaped gradient over the noisy samples (nominal excluded)
    order = torch.argsort(noisy_rets[1:], stable=True)    # best first
    w = fitness_weights(n_noisy - 1, dtype, dev)
    sorted_noise = noise.index_select(0, order)
    grad = torch.einsum("k,kpu->pu", w, sorted_noise) / (n_noisy - 1)
    grad = config.gradient_filter * grad + \
        (1.0 - config.gradient_filter) * state.gradient

    # gradient candidates at log-spaced steps
    steps = torch.logspace(float(np.log10(config.max_step)),
                           float(np.log10(config.min_step)), n_grad,
                           dtype=dtype, device=dev)
    scaling = steps / max(config.exploration, 1e-8)
    grad_vals = sampling.clip_ctrl(
        m, values[None] - scaling[:, None, None] * grad[None])
    grad_rets = score(grad_vals)

    all_vals = torch.cat([noisy_all, grad_vals], dim=0)
    all_rets = torch.cat([noisy_rets, grad_rets], dim=0)
    winner = torch.argmin(all_rets)
    info = {
        # per-candidate returns, candidate 0 the noiseless nominal
        "returns": all_rets,
        "best_return": sampling.pick(all_rets, winner),
        "nominal_return": noisy_rets[0],
        "winner": winner,
        "from_gradient": winner >= n_noisy,
        "gradient": grad,
    }
    new_policy = policy.replace(values=sampling.pick(all_vals, winner))
    return SGState(policy=new_policy, gradient=grad), info

  optimize.routes = dict(batched.routes) if batched is not None else \
      dict(getattr(returns_fn, "routes", {}))
  return optimize


class SampleGradientPlanner:
  """Host-side wrapper (reference GUI name: "Sample Gradient"); `lane` and
  `routes` as in CrossEntropyPlanner."""

  def __init__(self, task, config: Optional[SampleGradientConfig] = None,
               lane: Optional[bool] = None, device="cuda", **kernel_kw):
    self.device = check_device(device)
    if task.device != self.device:
      raise ValueError(f"task lives on {task.device}, planner asked for "
                       f"{self.device}")
    self.task = task
    self.m = getattr(task, "plan_model", task.model)
    self.config = config or make_config(task)
    returns_fn = sampling.lane_returns_fn(
        task, self.config, lane, self.device, **kernel_kw)
    self.lane = returns_fn is not None
    residual_fn = lambda m, d: task.residual(m, d, task.residual_params)
    self._optimize = make_optimize_fn(
        self.m, residual_fn, task.cost_spec, self.config,
        residual_fn_with_params=getattr(task, "residual", None),
        returns_fn=returns_fn)
    self.routes = dict(self._optimize.routes)
    self.state = initial_state(self.m, self.config, self.device)
    self.last_info = None

  def optimize(self, gen, d0, noise=None):
    self.state, info = self._optimize(gen, d0, self.state,
                                      self.task.residual_params,
                                      self.task.cost_spec, noise=noise)
    self.last_info = info
    return info

  @property
  def policy(self):
    return self.state.policy

  def action(self, time) -> torch.Tensor:
    return sampling.clip_ctrl(self.m,
                              spline_lib.sample(self.state.policy, time))
