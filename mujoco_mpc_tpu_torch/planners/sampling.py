"""Predictive sampling: configuration and candidate generation.

  * resample the nominal spline onto the current time window;
  * K candidates = nominal + zero-mean Gaussian noise per spline node,
    scaled by half the ctrl range and the exploration std; with
    probability 0.2 a candidate uses the second exploration std if set;
    candidate 0 is the noiseless nominal;
  * roll out all candidates, pick the argmin of the return;
  * the winner becomes the new nominal.

The rollout-and-score step lives in ops/sampling_lane.py (the rollout
kernel); the planner built on batched pipeline physics arrives with that
physics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.physics.model import Model

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
  return torch.minimum(torch.maximum(noisy, ctrlrange[:, 0]),
                       ctrlrange[:, 1])
