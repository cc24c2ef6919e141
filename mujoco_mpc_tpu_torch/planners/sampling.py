"""Predictive sampling: configuration and candidate generation.

  * resample the nominal spline onto the current time window;
  * K candidates = nominal + zero-mean Gaussian noise per spline node,
    scaled by half the ctrl range and the exploration std; with
    probability 0.2 a candidate uses the second exploration std if set;
    candidate 0 is the noiseless nominal;
  * roll out all candidates, pick the argmin of the return;
  * the winner becomes the new nominal.

Two routes roll out and score the candidates: ops/sampling_lane.py (the
rollout kernel, one launch for all candidates) and `make_optimize_fn` /
`SamplingPlanner` below, the batched pipeline physics of rollout.py (every
SPD solve through the batched Cholesky kernel, the returns from one launch
of the fused scoring kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.physics.model import Model, check_device

STD2_PROPORTION = 0.2


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
  num_trajectory: int = 10
  num_spline_points: int = 10
  interp: int = spline_lib.Interpolation.ZERO
  exploration: tuple = (0.1, 0.0)   # two noise stds
  horizon: int = 100
  sliding_plan: bool = False


def make_config(task) -> SamplingConfig:
  """Read the planner config from the task's custom numerics."""
  horizon_time = task.config("agent_horizon", 1.0)
  timestep = float(task.model.opt.timestep)
  agent_timestep = task.config("agent_timestep", timestep)
  steps = int(round(horizon_time / agent_timestep)) + 1
  return SamplingConfig(
      num_trajectory=int(task.config("sampling_trajectories", 10)),
      num_spline_points=int(task.config("sampling_spline_points", 10)),
      interp=int(task.config("sampling_representation",
                             spline_lib.Interpolation.ZERO)),
      exploration=(task.config("sampling_exploration", 0.1), 0.0),
      horizon=steps,
      sliding_plan=bool(task.config("sampling_sliding_plan", 0)))


def node_spacing(m: Model, config: SamplingConfig) -> float:
  """Node spacing dt = horizon_time / (P - extra): zero-order splines
  divide the window into P cells, linear/cubic into P-1."""
  p = config.num_spline_points
  denom = p if config.interp == spline_lib.Interpolation.ZERO else max(
      p - 1, 1)
  horizon_time = (config.horizon - 1) * float(m.opt.timestep)
  return max(horizon_time / denom, 1e-5)


def initial_policy(m: Model, config: SamplingConfig,
                   device="cuda") -> spline_lib.SplinePolicy:
  p = config.num_spline_points
  ctrlrange = m.actuator_ctrlrange.to(device)
  mid = 0.5 * (ctrlrange[:, 0] + ctrlrange[:, 1])
  f32 = dict(dtype=torch.float32, device=device)
  return spline_lib.SplinePolicy(
      t0=torch.zeros((), **f32),
      dt=torch.tensor(node_spacing(m, config), **f32),
      values=mid[None].repeat(p, 1).to(torch.float32),
      interp=config.interp)


def add_noise(gen: Optional[torch.Generator], policy_values: torch.Tensor,
              m: Model, exploration, k: int,
              noise: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Per-candidate Gaussian spline noise -> (k, P, nu) noisy node sets.

  `noise` (k, P, nu) standard normals and `u` (k,) uniforms may be given
  pre-drawn (tests feed two implementations the same numbers); otherwise
  they are drawn from `gen` on the device of `policy_values`."""
  dev, dtype = policy_values.device, policy_values.dtype
  ctrlrange = m.actuator_ctrlrange.to(dev)
  scale = 0.5 * (ctrlrange[:, 1] - ctrlrange[:, 0])
  if u is None:
    u = torch.rand((k,), generator=gen, device=dev, dtype=dtype)
  if noise is None:
    noise = torch.randn((k,) + tuple(policy_values.shape), generator=gen,
                        device=dev, dtype=dtype)
  std1, std2 = float(exploration[0]), float(exploration[1])
  use2 = (u < STD2_PROPORTION) & (std2 > 0)
  std = torch.where(use2, torch.full_like(u, std2),
                    torch.full_like(u, std1))
  noisy = policy_values[None] + noise * scale[None, None, :] * \
      std[:, None, None]
  return clip_ctrl(m, noisy)


def clip_ctrl(m: Model, values: torch.Tensor) -> torch.Tensor:
  ctrlrange = m.actuator_ctrlrange.to(values.device)
  return torch.minimum(torch.maximum(values, ctrlrange[:, 0]),
                       ctrlrange[:, 1])


def pick(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
  """x[index] for a 0-d index tensor without reading it back on the host
  (indexing with a 0-d tensor would stall the card every iteration)."""
  return x.index_select(0, index.reshape(1))[0]


def make_optimize_fn(m: Model, residual_fn, cost_spec,
                     config: SamplingConfig, residual_fn_with_params=None):
  """Predictive sampling on the batched pipeline rollouts
  (rollout.make_batched_returns).

  Returns `optimize(gen, d0, policy, residual_params=None, cost_spec=None,
  noise=None, u=None) -> (new_policy, info)`; `noise` / `u` are optional
  pre-drawn numbers for `add_noise`. `cost_spec` at call time may carry
  other weights (same terms). Raises NotImplementedError, naming what is
  missing, for a model the pipeline physics cannot step.
  `optimize.routes` says which route each stage takes."""
  horizon = config.horizon
  k_noise = config.num_trajectory - 1
  batched = rollout_lib.make_batched_returns(
      m, residual_fn, cost_spec, horizon, config.interp)

  def optimize(gen, d0, policy: spline_lib.SplinePolicy,
               residual_params=None, cost_spec=None, noise=None, u=None):
    rf = residual_fn
    if residual_params is not None and residual_fn_with_params is not None:
      rf = lambda mm, dd: residual_fn_with_params(mm, dd, residual_params)
    dtype = policy.values.dtype
    horizon_time = (horizon - 1) * m.opt.timestep
    if config.sliding_plan:
      # sliding keeps node values; dt pinned to the horizon grid
      policy = policy.replace(dt=torch.full(
          (), node_spacing(m, config), dtype=dtype,
          device=policy.values.device))
      policy = spline_lib.slide(policy, d0.time)
    else:
      policy = spline_lib.resample(policy, d0.time, horizon_time)

    noisy = add_noise(gen, policy.values, m, config.exploration, k_noise,
                      noise=noise, u=u)
    candidates = torch.cat([policy.values[None], noisy], dim=0)
    returns, failure, _ = batched(candidates, policy.t0, policy.dt, d0,
                                  cost_spec, residual_fn=rf)
    winner = torch.argmin(returns)
    new_policy = policy.replace(values=pick(candidates, winner))
    info = {
        "returns": returns,
        "winner": winner,
        "best_return": pick(returns, winner),
        "nominal_return": returns[0],
        "failures": torch.sum(failure),
    }
    return new_policy, info

  optimize.routes = dict(batched.routes)
  return optimize


class SamplingPlanner:
  """Predictive sampling on the batched pipeline physics (reference GUI
  name: "Sampling"). Lives on `device` (default "cuda"); raises if that
  device is unavailable, or — naming what is missing — if the pipeline
  physics cannot step the planning model (e.g. contacts: the lane planner,
  ops/sampling_lane.py, is the route for those). `routes` says which
  route each stage takes."""

  def __init__(self, task, config: Optional[SamplingConfig] = None,
               device="cuda"):
    self.device = check_device(device)
    if task.device != self.device:
      raise ValueError(f"task lives on {task.device}, planner asked for "
                       f"{self.device}")
    self.task = task
    self.m = getattr(task, "plan_model", task.model)
    self.config = config or make_config(task)
    residual_fn = lambda m, d: task.residual(m, d, task.residual_params)
    self._optimize = make_optimize_fn(
        self.m, residual_fn, task.cost_spec, self.config,
        residual_fn_with_params=getattr(task, "residual", None))
    self.routes = dict(self._optimize.routes)
    self.policy = initial_policy(self.m, self.config, self.device)
    self.last_info = None

  def optimize(self, gen, d0, noise=None, u=None):
    self.policy, info = self._optimize(gen, d0, self.policy,
                                       self.task.residual_params,
                                       self.task.cost_spec, noise=noise, u=u)
    self.last_info = info
    return info

  def action(self, time) -> torch.Tensor:
    return clip_ctrl(self.m, spline_lib.sample(self.policy, time))


def lane_returns_fn(task, config, lane: Optional[bool], device,
                    **kernel_kw):
  """The sampling-family planners' choice of scorer: the lane rollout
  kernel's `returns_fn` (ops/sampling_lane.py) when `lane` is True, or None
  on a CUDA device; None (the batched pipeline rollouts) when `lane` is
  False, or None on the CPU. Raises NotImplementedError naming the gate when
  the lane scorer was asked for (or is the device's default) and the task
  or model is outside it."""
  if lane is None:
    lane = torch.device(device).type == "cuda"
  if not lane:
    return None
  if not (hasattr(task, "lane_residual_spec") or
          hasattr(task, "residual_from_rollout")):
    raise NotImplementedError(
        f"task {type(task).__name__} has neither lane_residual_spec nor "
        "residual_from_rollout, so the lane rollout kernel cannot score it; "
        "pass lane=False to take the batched pipeline rollouts")
  from mujoco_mpc_tpu_torch.ops import sampling_lane
  return sampling_lane.make_lane_returns_fn(task, config, **kernel_kw)
