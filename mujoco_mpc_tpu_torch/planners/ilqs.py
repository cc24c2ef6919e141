"""iLQS planner: alternate predictive sampling and iLQG.

Semantics (those of the JAX package's planners/ilqs.py, which follows
mjpc/planners/ilqs/): run sampling, seed iLQG's nominal actions from the
sampling winner (spline -> action trajectory), run an iLQG iteration at the
sampler's horizon, keep whichever policy wins; when iLQG wins, its action
trajectory is fitted back into spline nodes (spline.fit) for the sampler.

The sampler is the lane planner (ops/sampling_lane.py) or the pipeline one
(planners/sampling.py); iLQG takes its own routes (planners/ilqg.py). The
comparison of the two returns is two host reads an iteration, as in the
JAX package; `info["host_readbacks"]` counts them with iLQG's own.
"""

from __future__ import annotations

from typing import Optional

import torch

from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.physics.model import check_device
from mujoco_mpc_tpu_torch.planners import ilqg as ilqg_lib
from mujoco_mpc_tpu_torch.planners import sampling as sampling_lib


class ILQSPlanner:
  """Host-side wrapper (reference GUI name: "iLQS").

  `lane` picks the sampler: the lane planner (True, or None on a CUDA
  device) or the pipeline one (False, or None on the CPU); iLQG takes its
  own default routes (planners/ilqg.py). `routes` says which route each
  stage takes."""

  def __init__(self, task, lane: Optional[bool] = None, device="cuda",
               sampler_config=None, **kernel_kw):
    self.device = check_device(device)
    self.task = task
    self.m = getattr(task, "plan_model", task.model)
    if lane is None:
      lane = self.device.type == "cuda"
    if lane:
      from mujoco_mpc_tpu_torch.ops import sampling_lane
      self.sampler = sampling_lane.LaneSamplingPlanner(
          task, sampler_config, device=self.device, **kernel_kw)
    else:
      self.sampler = sampling_lib.SamplingPlanner(
          task, sampler_config, device=self.device)
    self.lane = lane
    # match horizons so the trajectories are interchangeable
    ilqg_cfg = ilqg_lib.make_config(task).replace(
        horizon=self.sampler.config.horizon)
    self.ilqg = ilqg_lib.ILQGPlanner(task, ilqg_cfg, device=self.device)
    self.routes = dict(
        sampler=("lane" if lane else "pipeline"),
        **{f"sampler_{k}": v for k, v in self.sampler.routes.items()},
        **{f"ilqg_{k}": v for k, v in self.ilqg.routes.items()})
    self.active = "sampling"
    self.last_info = None

  def optimize(self, gen, d0):
    s_info = self.sampler.optimize(gen, d0)

    # seed iLQG's nominal actions from the sampling winner
    pol = self.sampler.policy
    horizon = self.ilqg.config.horizon
    times = d0.time + self.m.opt.timestep * torch.arange(
        horizon, dtype=pol.values.dtype, device=pol.values.device)
    actions = spline_lib.sample(pol, times)
    self.ilqg.policy = self.ilqg.policy.replace(actions=actions)
    i_info = self.ilqg.optimize(None, d0)

    s_ret = float(s_info["best_return"])      # the two host reads
    i_ret = float(i_info["best_return"])
    if i_ret < s_ret:
      self.active = "ilqg"
      # the winning action trajectory back into the spline nominal
      cfg = self.sampler.config
      fitted = spline_lib.fit(self.ilqg.policy.actions,
                              self.ilqg.policy.times, pol.t0, pol.dt,
                              cfg.num_spline_points, cfg.interp)
      self.sampler.policy = pol.replace(
          values=sampling_lib.clip_ctrl(self.m, fitted))
    else:
      self.active = "sampling"
    info = {
        "best_return": min(s_ret, i_ret),
        "sampling_return": s_ret,
        "ilqg_return": i_ret,
        "active": self.active,
        "host_readbacks": 2 + i_info["host_readbacks"],
    }
    self.last_info = info
    return info

  @property
  def policy(self):
    return (self.sampler.policy if self.active == "sampling"
            else self.ilqg.policy)

  def action(self, time, state=None) -> torch.Tensor:
    if self.active == "ilqg":
      return self.ilqg.action(time, state)
    return self.sampler.action(time)
