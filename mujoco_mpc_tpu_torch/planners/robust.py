"""Robust (meta-)planner.

Semantics (those of the JAX package's planners/robust.py, which follows
mjpc/planners/robust/): predictive sampling's K candidates are scored
clean; the top N are re-rolled M times each under Ornstein-Uhlenbeck body
wrench perturbations (std and rate from the `robust_xfrc` numerics); the
noisy returns are averaged per candidate and the most robust candidate
becomes the policy.

The K clean candidates go through the lane rollout kernel
(ops/sampling_lane.py) or the batched pipeline rollouts; the N x M noisy
re-rolls are one batch of pipeline rollouts (rollout.py: every SPD solve
through the batched Cholesky kernel, the returns from one launch of the
fused scoring kernel) — the rollout kernel has no body-wrench noise.
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
class RobustConfig:
  num_candidates: int = 4
  num_repetitions: int = 4
  xfrc_std: float = 0.2
  xfrc_rate: float = 0.1


def make_config(task) -> RobustConfig:
  return RobustConfig(
      num_candidates=int(task.config("robust_candidates", 4)),
      num_repetitions=int(task.config("robust_repetitions", 4)),
      xfrc_std=float(task.config("robust_xfrc", 0.2)),
      xfrc_rate=float(task.config("robust_xfrc_rate", 0.1)))


def make_optimize_fn(m: Model, residual_fn, cost_spec,
                     s_config: sampling.SamplingConfig,
                     r_config: RobustConfig, residual_fn_with_params=None,
                     returns_fn=None):
  """Returns `optimize(gen, d0, policy, residual_params=None,
  cost_spec=None, noise=None, u=None, xfrc_noise=None) -> (new_policy,
  info)`. `noise` / `u` are the candidates' pre-drawn numbers (as in
  `sampling.add_noise`), `xfrc_noise` (N*M, H-1, nbody, 6) the re-rolls'
  standard normals; each is drawn from `gen` when not given. `returns_fn`
  scores the K clean candidates (the lane kernel); without it the batched
  pipeline rollouts do."""
  horizon = s_config.horizon
  n_cand = min(r_config.num_candidates, s_config.num_trajectory)
  n_rep = r_config.num_repetitions
  k_noise = s_config.num_trajectory - 1
  clean = None
  if returns_fn is None:
    clean = rollout_lib.make_batched_returns(
        m, residual_fn, cost_spec, horizon, s_config.interp)
  noisy = rollout_lib.make_batched_returns(
      m, residual_fn, cost_spec, horizon, s_config.interp,
      xfrc_std=r_config.xfrc_std, xfrc_rate=r_config.xfrc_rate)

  def optimize(gen, d0, policy: spline_lib.SplinePolicy,
               residual_params=None, cost_spec=None, noise=None, u=None,
               xfrc_noise=None):
    rf = residual_fn
    if residual_params is not None and residual_fn_with_params is not None:
      rf = lambda mm, dd: residual_fn_with_params(mm, dd, residual_params)
    horizon_time = (horizon - 1) * m.opt.timestep
    policy = spline_lib.resample(policy, d0.time, horizon_time)

    # delegate: sampling candidates, clean returns
    noisy_vals = sampling.add_noise(gen, policy.values, m,
                                    s_config.exploration, k_noise,
                                    noise=noise, u=u)
    candidates = torch.cat([policy.values[None], noisy_vals], dim=0)
    if returns_fn is not None:
      returns = returns_fn(candidates, d0, residual_params, cost_spec)
    else:
      returns = clean(candidates, policy.t0, policy.dt, d0, cost_spec,
                      residual_fn=rf)[0]

    # top-N candidates by clean return, each re-rolled M times
    _, top_idx = torch.topk(-returns, n_cand)
    top = candidates.index_select(0, top_idx)             # (N, P, nu)
    flat_vals = top.repeat_interleave(n_rep, dim=0)       # (N*M, P, nu)
    if xfrc_noise is None:
      xfrc_noise = torch.randn(
          (n_cand * n_rep, horizon - 1) + tuple(d0.xfrc_applied.shape),
          generator=gen, dtype=d0.xfrc_applied.dtype,
          device=d0.xfrc_applied.device)
    noisy_rets = noisy(flat_vals, policy.t0, policy.dt, d0, cost_spec,
                       noise=xfrc_noise, residual_fn=rf)[0]
    avg = torch.mean(noisy_rets.reshape(n_cand, n_rep), dim=1)
    winner = torch.argmin(avg)
    top_winner = sampling.pick(top_idx, winner)

    info = {
        "returns": returns,
        "best_return": sampling.pick(returns, top_winner),
        "robust_return": sampling.pick(avg, winner),
        "winner": top_winner,
        "noisy_returns": noisy_rets,
    }
    return policy.replace(values=sampling.pick(top, winner)), info

  clean_routes = clean.routes if clean is not None else returns_fn.routes
  optimize.routes = dict(
      clean_rollouts=clean_routes["rollouts"],
      clean_scoring=clean_routes["scoring"],
      noisy_rollouts=noisy.routes["rollouts"],
      noisy_scoring=noisy.routes["scoring"],
      spd_solve=noisy.routes["spd_solve"])
  return optimize


class RobustPlanner:
  """Host-side wrapper (reference GUI name: "Robust Sampling"). `lane`
  picks the clean scorer as in CrossEntropyPlanner; the noisy re-rolls are
  always the batched pipeline rollouts, so the planning model must be one
  the pipeline physics can step (NotImplementedError names what is
  missing otherwise). `routes` says which route each stage takes."""

  def __init__(self, task,
               s_config: Optional[sampling.SamplingConfig] = None,
               r_config: Optional[RobustConfig] = None,
               lane: Optional[bool] = None, device="cuda", **kernel_kw):
    self.device = check_device(device)
    if task.device != self.device:
      raise ValueError(f"task lives on {task.device}, planner asked for "
                       f"{self.device}")
    self.task = task
    self.m = getattr(task, "plan_model", task.model)
    self.s_config = s_config or sampling.make_config(task)
    self.r_config = r_config or make_config(task)
    returns_fn = sampling.lane_returns_fn(
        task, self.s_config, lane, self.device, **kernel_kw)
    self.lane = returns_fn is not None
    residual_fn = lambda m, d: task.residual(m, d, task.residual_params)
    self._optimize = make_optimize_fn(
        self.m, residual_fn, task.cost_spec, self.s_config, self.r_config,
        residual_fn_with_params=getattr(task, "residual", None),
        returns_fn=returns_fn)
    self.routes = dict(self._optimize.routes)
    self.policy = sampling.initial_policy(self.m, self.s_config, self.device)
    self.last_info = None

  def optimize(self, gen, d0, noise=None, u=None, xfrc_noise=None):
    self.policy, info = self._optimize(
        gen, d0, self.policy, self.task.residual_params, self.task.cost_spec,
        noise=noise, u=u, xfrc_noise=xfrc_noise)
    self.last_info = info
    return info

  def action(self, time) -> torch.Tensor:
    return sampling.clip_ctrl(self.m, spline_lib.sample(self.policy, time))
