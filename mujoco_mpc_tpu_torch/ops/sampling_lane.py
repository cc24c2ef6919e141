"""Sampling-family planning on the lane-parallel rollout kernel.

One planner iteration = candidate generation + ONE kernel call rolling out
all candidates + scoring + argmin. `make_lane_returns_fn` is the shared
candidate scorer ((K, P, nu) node sets -> (K,) returns); predictive
sampling (`make_lane_optimize_fn` / `LaneSamplingPlanner`) rides it, and
so do cross-entropy, sample-gradient, robust (its clean batch) and iLQS
(its sampler). Tasks opt in by implementing
`lane_residual_spec()` (in-kernel residual) or
`residual_from_rollout(states, ctrls, times, params)` mapping the
kernel's raw (H, nq+nv, K) output to (H, nr, K) residuals.
"""

from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.ops import scoring, step_lane
from mujoco_mpc_tpu_torch.physics.model import check_device
from mujoco_mpc_tpu_torch.planners import sampling


def lane_residual_spec(task, horizon: int) -> Optional[dict]:
  """The task's lane residual spec, or None if it has none. A spec whose
  signature takes `horizon` (time-varying targets packed as per-step aux
  rows, e.g. tracking) is given it."""
  if not hasattr(task, "lane_residual_spec"):
    return None
  if "horizon" in inspect.signature(task.lane_residual_spec).parameters:
    return task.lane_residual_spec(horizon=horizon)
  return task.lane_residual_spec()


def make_lane_returns_fn(task, config, solver_iters=None,
                         solver_ls_iters=None, contact_types=None,
                         contact_geoms="task"):
  """Candidate scorer on the lane kernel.

  Returns `returns_fn(candidates, d0, residual_params=None,
  cost_spec=None)` mapping a (K, P, nu) batch of spline node sets to their
  (K,) trajectory returns (horizon-mean weighted cost, divergent rollouts
  poisoned to 1e6). `config` needs `num_spline_points`, `horizon`,
  `interp` (must be zero-order-hold).

  Residuals come from one of two task hooks, preferred in order:
  1. `lane_residual_spec()` — the residual is evaluated IN-KERNEL per step
     on the full derived quantities (FK, com, body velocities, actuator
     forces). With a risk-neutral cost the kernel also reduces the rows to
     UNWEIGHTED per-term norm sums over the horizon (weights are applied
     outside, so live weight changes rebuild nothing); a risk-sensitive
     cost needs the per-step transform and keeps the residual-row output.
  2. `residual_from_rollout(states, ctrls, times, params)` — the residual
     is reconstructed from the raw (H, nq+nv, K) states (tasks whose cost
     needs no FK) and scored by ONE launch of the fused scoring kernel
     (ops/scoring.py; its gate as in `make_scorer`).

  `returns_fn.routes["scoring"]` says where the rows become returns:
  "rollout_kernel" (cost sums inside the rollout kernel), "kernel" (the
  fused scoring kernel) or "plain" (the cost as torch ops: a risk-sensitive
  cost on an in-kernel residual, whose rows the fused kernel does not
  score — its own gate).
  """
  m = getattr(task, "plan_model", task.model)
  if config.interp != spline_lib.Interpolation.ZERO:
    raise ValueError("the lane kernel holds spline nodes zero-order; got "
                     f"interp={config.interp}")
  spec = lane_residual_spec(task, config.horizon)
  if spec is None and not hasattr(task, "residual_from_rollout"):
    raise ValueError(
        "task must implement lane_residual_spec or residual_from_rollout")
  horizon = config.horizon
  p = config.num_spline_points
  nu = m.nu
  if contact_geoms == "task":
    # planning-contact whitelist (e.g. feet only) declared by the task
    contact_geoms = getattr(task, "plan_contact_geoms", None)
  # body-body pairs in the planning dynamics (hand manipulation), with the
  # task's optional pair-type whitelist (e.g. Rubik drops its box-box pairs)
  body_pairs = bool(getattr(task, "plan_body_pairs", False))
  body_pair_types = getattr(task, "plan_body_pair_types", None)
  risk0 = abs(float(task.cost_spec.risk)) < 1e-6
  cost_terms = None
  if spec is not None and risk0:
    cost_terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
  kw = dict(contact_types=contact_types, contact_geoms=contact_geoms,
            solver_iters=solver_iters, solver_ls_iters=solver_ls_iters,
            body_pairs=body_pairs, body_pair_types=body_pair_types)
  scorer = None
  if spec is None:
    scorer = scoring.make_scorer(task.cost_spec, m.qpos0.device)
    route = scorer.route
  else:
    route = "rollout_kernel" if cost_terms is not None else "plain"
  if spec is not None:
    # the planner only needs residual rows (or their sums) and the final
    # state's finiteness
    kernel = step_lane.build_rollout_kernel(
        m, horizon, p, residual=spec, naux=spec["naux"],
        record_states=False, cost_terms=cost_terms, **kw)
  else:
    kernel = step_lane.build_rollout_kernel(m, horizon, p, **kw)
  h = float(m.opt.timestep)
  node_of = torch.as_tensor(np.array(
      [min(int(t * p / max(horizon - 1, 1)), p - 1)
       for t in range(horizon)])).to(m.qpos0.device)

  def returns_fn(candidates, d0, residual_params=None, cost_spec=None):
    """(K, P, nu) candidate node sets -> (K,) returns (1e6 on
    divergence). residual_params / cost_spec default to the task's
    current values."""
    if residual_params is None:
      residual_params = task.residual_params
    if cost_spec is None:
      cost_spec = task.cost_spec
    k = candidates.shape[0]
    dtype = candidates.dtype

    # kernel layout: candidates on the last axis
    values_lane = candidates.reshape(k, p * nu).T.contiguous()  # (P*nu, K)
    qpos0 = d0.qpos[:, None].repeat(1, k)
    qvel0 = d0.qvel[:, None].repeat(1, k)
    if spec is not None and cost_terms is not None:
      aux_rows = torch.cat([
          spec["make_aux"](d0, residual_params).to(dtype),
          cost_spec.norm_params[:, :2].reshape(-1).to(dtype)])
      aux = aux_rows[:, None].repeat(1, k)
      term_sums, final_state = kernel(qpos0, qvel0, values_lane, aux)
      # mean over horizon of the weighted per-step cost == weighted
      # per-term sums / horizon (risk-neutral; gated at build time)
      returns = torch.sum(
          cost_spec.weights[:, None] * term_sums, dim=0) / horizon
    elif spec is not None:
      aux = spec["make_aux"](d0, residual_params).to(dtype)[:, None].repeat(
          1, k)
      residuals, final_state = kernel(qpos0, qvel0, values_lane, aux)
      costs = cost_spec.cost(residuals.movedim(1, -1))      # (H, K)
      returns = torch.mean(costs, dim=0)
    else:
      states = kernel(qpos0, qvel0, values_lane)            # (H, nq+nv, K)
      times = d0.time + h * torch.arange(horizon, dtype=dtype,
                                         device=candidates.device)
      ctrls = candidates.index_select(1, node_of)           # (K, H, nu)
      ctrls = ctrls.movedim(0, -1)                          # (H, nu, K)
      residuals = task.residual_from_rollout(states, ctrls, times,
                                             residual_params)  # (H, nr, K)
      returns = scorer(residuals, cost_spec)
      final_state = states[-1]
    return torch.where(torch.all(torch.isfinite(final_state), dim=0),
                       returns, torch.full_like(returns, 1e6))

  returns_fn.kernel = kernel
  returns_fn.routes = dict(rollouts="rollout_kernel", scoring=route)
  return returns_fn


def make_lane_optimize_fn(task, config: sampling.SamplingConfig,
                          **kernel_kw):
  """Predictive-sampling optimizer for lane-eligible tasks: noise
  generation + ONE lane-kernel scoring call + argmin.

  Returns `optimize(gen, d0, policy, residual_params=None,
  cost_spec=None, noise=None, u=None) -> (new_policy, info)`; `noise` /
  `u` are optional pre-drawn numbers for `sampling.add_noise`."""
  m = getattr(task, "plan_model", task.model)
  horizon = config.horizon
  k_total = config.num_trajectory
  returns_fn = make_lane_returns_fn(task, config, **kernel_kw)

  def optimize(gen, d0, policy: spline_lib.SplinePolicy,
               residual_params=None, cost_spec=None, noise=None, u=None):
    horizon_time = (horizon - 1) * m.opt.timestep
    policy = spline_lib.resample(policy, d0.time, horizon_time)

    noisy = sampling.add_noise(gen, policy.values, m, config.exploration,
                               k_total - 1, noise=noise, u=u)
    candidates = torch.cat([policy.values[None], noisy], dim=0)
    returns = returns_fn(candidates, d0, residual_params, cost_spec)

    # index_select, not candidates[winner]: indexing with a 0-d tensor
    # reads it back on the host and would stall the card every iteration
    winner = torch.argmin(returns)
    pick = winner.reshape(1)
    new_policy = policy.replace(values=candidates.index_select(0, pick)[0])
    info = {
        "returns": returns,
        "winner": winner,
        "best_return": returns.index_select(0, pick)[0],
        "nominal_return": returns[0],
    }
    return new_policy, info

  optimize.returns_fn = returns_fn
  return optimize


class LaneSamplingPlanner:
  """Predictive sampling on the rollout kernel.

  Lives on `device` (default "cuda": every iteration is one kernel launch
  plus a handful of small tensor ops, nothing is synchronised); raises if
  that device is unavailable. The task must live on the same device."""

  def __init__(self, task, config: Optional[sampling.SamplingConfig] = None,
               device="cuda", **kernel_kw):
    device = check_device(device)
    if task.device.type != device.type:
      raise ValueError(f"task lives on {task.device}, planner on {device}")
    self.task = task
    self.device = device
    self.m = getattr(task, "plan_model", task.model)
    self.config = config or sampling.make_config(task)
    self._optimize = make_lane_optimize_fn(task, self.config, **kernel_kw)
    self.routes = dict(self._optimize.returns_fn.routes)
    self.policy = sampling.initial_policy(self.m, self.config, device)
    self.last_info = None
    if device.type == "cuda":
      # load the kernel and pack its constant tables now, not inside the
      # first iteration (an agent rebuilds its planner on reset)
      self._optimize.returns_fn.kernel.library()

  def optimize(self, gen, d0, noise=None, u=None):
    """One iteration; `noise` / `u` are optional pre-drawn numbers for
    `sampling.add_noise`."""
    self.policy, info = self._optimize(gen, d0, self.policy,
                                       self.task.residual_params,
                                       self.task.cost_spec, noise=noise, u=u)
    self.last_info = info
    return info

  def action(self, time) -> torch.Tensor:
    u = spline_lib.sample(self.policy, time)
    ctrlrange = self.m.actuator_ctrlrange
    return torch.minimum(torch.maximum(u, ctrlrange[:, 0]), ctrlrange[:, 1])
