"""Cross-Entropy Method planner.

Semantics (those of the JAX package's planners/cross_entropy.py, which
follows mjpc/planners/cross_entropy/):
  * K candidates = resampled nominal + Gaussian noise with per-parameter
    std sqrt(variance) floored at std_min; all candidates, the nominal
    included, are clipped to the control range;
  * new policy = MEAN of the n_elite best candidates' spline nodes; their
    unbiased variance (/(n-1)) is the next iteration's sampling variance,
    initialised to std_initial^2;
  * n_elite defaults to max(K/10, 2).

The candidates are scored in one call: the lane rollout kernel
(ops/sampling_lane.py, `returns_fn`) or the batched pipeline rollouts
(rollout.py: batched Cholesky kernel + fused scoring kernel). The elite
refit is a handful of torch ops; nothing is read back on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.physics.model import Model, check_device
from mujoco_mpc_tpu_torch.planners import sampling


@dataclasses.dataclass(frozen=True)
class CEMConfig:
  num_trajectory: int = 64
  num_spline_points: int = 10
  n_elite: int = 6
  interp: int = spline_lib.Interpolation.ZERO
  std_initial: float = 0.3
  std_min: float = 0.1
  horizon: int = 100

  def replace(self, **kw) -> "CEMConfig":
    return dataclasses.replace(self, **kw)


def make_config(task) -> CEMConfig:
  horizon_time = task.config("agent_horizon", 1.0)
  agent_timestep = task.config("agent_timestep",
                               float(task.model.opt.timestep))
  k = int(task.config("sampling_trajectories", 64))
  return CEMConfig(
      num_trajectory=k,
      num_spline_points=int(task.config("sampling_spline_points", 10)),
      n_elite=int(task.config("n_elite", max(k // 10, 2))),
      interp=int(task.config("sampling_representation",
                             spline_lib.Interpolation.ZERO)),
      std_initial=float(task.config("std_initial", 0.3)),
      std_min=float(task.config("std_min", 0.1)),
      horizon=int(round(horizon_time / agent_timestep)) + 1)


@dataclasses.dataclass(frozen=True)
class CEMState:
  policy: spline_lib.SplinePolicy
  variance: torch.Tensor  # (P, nu)


def initial_state(m: Model, config: CEMConfig, device="cuda") -> CEMState:
  p = config.num_spline_points
  ctrlrange = m.actuator_ctrlrange.to(device)
  mid = 0.5 * (ctrlrange[:, 0] + ctrlrange[:, 1])
  f32 = dict(dtype=torch.float32, device=device)
  policy = spline_lib.SplinePolicy(
      t0=torch.zeros((), **f32), dt=torch.tensor(0.1, **f32),
      values=mid[None].repeat(p, 1).to(torch.float32), interp=config.interp)
  var = torch.full((p, m.nu), config.std_initial ** 2, **f32)
  return CEMState(policy=policy, variance=var)


def make_optimize_fn(m: Model, residual_fn, cost_spec, config: CEMConfig,
                     residual_fn_with_params=None, returns_fn=None):
  """Returns `optimize(gen, d0, state, residual_params=None, cost_spec=None,
  noise=None) -> (new_state, info)`; `noise` (K-1, P, nu) standard normals
  may be given pre-drawn. `returns_fn(candidates, d0, residual_params,
  cost_spec) -> (K,)` scores the candidates in one call (the lane kernel);
  without it the batched pipeline rollouts do."""
  horizon = config.horizon
  k = config.num_trajectory
  n_elite = min(config.n_elite, k)
  batched = None
  if returns_fn is None:
    batched = rollout_lib.make_batched_returns(
        m, residual_fn, cost_spec, horizon, config.interp)

  def optimize(gen, d0, state: CEMState, residual_params=None,
               cost_spec=None, noise=None):
    horizon_time = (horizon - 1) * m.opt.timestep
    policy = spline_lib.resample(state.policy, d0.time, horizon_time)
    values = policy.values

    std = torch.clamp(torch.sqrt(state.variance), min=config.std_min)
    if noise is None:
      noise = torch.randn((k - 1,) + tuple(values.shape), generator=gen,
                          dtype=values.dtype, device=values.device)
    candidates = torch.cat([values[None], values[None] + noise * std[None]],
                           dim=0)
    candidates = sampling.clip_ctrl(m, candidates)

    if returns_fn is not None:
      rets = returns_fn(candidates, d0, residual_params, cost_spec)
      failures = torch.sum(rets >= rollout_lib.MAX_RETURN_VALUE)
    else:
      rf = residual_fn
      if residual_params is not None and residual_fn_with_params is not None:
        rf = lambda mm, dd: residual_fn_with_params(mm, dd, residual_params)
      rets, failure, _ = batched(candidates, policy.t0, policy.dt, d0,
                                 cost_spec, residual_fn=rf)
      failures = torch.sum(failure)

    # elites: the n_elite best returns
    neg_ret, elite_idx = torch.topk(-rets, n_elite)
    elites = candidates.index_select(0, elite_idx)      # (n_elite, P, nu)
    mean = torch.mean(elites, dim=0)
    var = torch.sum((elites - mean[None]) ** 2, dim=0) / max(n_elite - 1, 1)

    info = {
        "returns": rets,
        "best_return": -neg_ret[0],
        "elite_avg_return": torch.mean(-neg_ret),
        "winner": elite_idx[0],
        "failures": failures,
    }
    return CEMState(policy=policy.replace(values=mean), variance=var), info

  optimize.routes = dict(batched.routes) if batched is not None else \
      dict(getattr(returns_fn, "routes", {}))
  return optimize


class CrossEntropyPlanner:
  """Host-side wrapper (reference GUI name: "Cross Entropy").

  `lane` picks the scorer (planners/sampling.lane_returns_fn): the lane
  rollout kernel (True, or None on a CUDA device; raises
  NotImplementedError naming the gate when the task is outside it) or the
  batched pipeline rollouts (False, or None on the CPU). `routes` says which
  route each stage takes."""

  def __init__(self, task, config: Optional[CEMConfig] = None,
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
