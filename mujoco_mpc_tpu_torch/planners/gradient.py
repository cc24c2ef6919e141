"""Gradient-descent planner (reference GUI name: "Gradient").

Semantics (those of the JAX package's planners/gradient.py): each
iteration resamples the spline policy onto the horizon, takes the value and
gradient of the rollout's total return with respect to the spline values by
reverse-mode differentiation through the pipeline physics, and runs a line
search over 8 log-scaled steps along the normalised negative gradient
(steps 0.5 * mean control-range width * logspace(0, -4)); the candidates are
clipped to the control range, rolled out as one batch, and the best is
kept if its return is below the nominal's.

The reverse pass is a loop of one step's vector-Jacobian product, not one
autograd graph of the whole rollout: the forward pass stores the rollout's
carry (qpos, qvel, act, ctrl, time: ~20 floats a step), and the reverse
pass recomputes each step from its carry under `torch.func.vjp`, taking
the carry's cotangent and returning the cotangents of the previous carry
and of the spline values (through the spline sample and the clip: under
zero-order hold a scatter-add masked where the clip is active). On a CUDA
device the forward step, the reverse step and the line search's batched
step (rollout.StepLoop) are each captured once as a CUDA graph and
replayed once a step, with the step index on the device: a step of the
pipeline physics is thousands of small operations, and an eager iteration
at Swimmer's horizon (201) would take tens of seconds. On the CPU the same
functions run eagerly (rollout.GraphedBody). The derivatives take the
library Cholesky route (`Model.solve_route = "library"`); the line search's
rollouts take the batched Cholesky kernel for every SPD solve, and the
fused scoring kernel gives their returns.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.ops import scoring
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.physics.model import Model, check_device
from mujoco_mpc_tpu_torch.planners import sampling as sampling_lib

STATE = rollout_lib.CARRY_STATE
NDIFF = 4           # qpos, qvel, act, ctrl: the differentiated carry


@dataclasses.dataclass(frozen=True)
class GradientConfig:
  num_spline_points: int = 10
  interp: int = spline_lib.Interpolation.ZERO
  horizon: int = 100
  num_steps: int = 8          # line search
  step_max: float = 1.0
  step_min: float = 1e-4

  def replace(self, **kw) -> "GradientConfig":
    return dataclasses.replace(self, **kw)


def make_config(task) -> GradientConfig:
  horizon_time = task.config("agent_horizon", 1.0)
  agent_timestep = task.config("agent_timestep",
                               float(task.model.opt.timestep))
  return GradientConfig(
      num_spline_points=int(task.config("gradient_spline_points", 10)),
      horizon=int(round(horizon_time / agent_timestep)) + 1)


class ValueAndGrad:
  """`fn(values (P, nu), t0, dt, d0, params, cost_spec) -> (return,
  gradient (P, nu), failure)`: the total return of the spline rollout from
  d0 (rollout.rollout's: 1e6 when it diverges) and its gradient with
  respect to the spline values (zero when it diverges).

  The forward pass runs `rollout.spline_step` H-1 times and the final
  forward pass, storing each step's carry; the reverse pass seeds the
  carry's cotangent from the final cost and runs H-1 vector-Jacobian
  products of one step, last step first, each recomputing its step from
  the stored carry. The inputs are copied into static buffers; the forward
  step, the closing step and the reverse step are each a
  rollout.GraphedBody (on a CUDA device a CUDA graph, captured at the
  first call and replayed after). `mark(stage)` is called after the
  forward pass ("forward") and the reverse pass ("reverse")."""

  def __init__(self, m: Model, residual_fn_with_params, horizon: int,
               interp: int):
    self.m, self.horizon = m, horizon
    self.step_fn, self.final_fn = rollout_lib.spline_step(
        m, residual_fn_with_params, interp)
    self.key = None

  def _setup(self, values, t0, dt, d0, params, cost_spec):
    h, dev = self.horizon, values.device
    self.buf = dict(values=values.clone(), t0=t0.clone(), dt=dt.clone(),
                    params=params.clone())
    # the cost's run-time tensors, read by the captured steps
    self.cs = cost_spec.replace(weights=cost_spec.weights.clone(),
                                norm_params=cost_spec.norm_params.clone(),
                                risk=cost_spec.risk.clone())
    self.consts = {f: getattr(d0, f).clone()
                   for f in rollout_lib.CARRY_CONST}
    self.state = [getattr(d0, f).clone() for f in STATE]
    self.hist = [torch.zeros((h,) + tuple(x.shape), dtype=x.dtype,
                             device=dev) for x in self.state]
    self.costs = torch.zeros((h,), dtype=values.dtype, device=dev)
    self.fails = torch.zeros((h,), dtype=torch.bool, device=dev)
    self.cbar = [torch.zeros_like(x) for x in self.state[:NDIFF]]
    self.grad = torch.zeros_like(values)
    self.inv_h = torch.full((), 1.0 / h, dtype=values.dtype, device=dev)
    self.t = torch.zeros((1,), dtype=torch.long, device=dev)
    self.fwd = rollout_lib.GraphedBody(self._fwd_body, dev)
    self.close = rollout_lib.GraphedBody(self._close_body, dev)
    self.rev = rollout_lib.GraphedBody(self._rev_body, dev)

  def _cost(self, r):
    return self.cs.cost(r[None])[0]

  def _fwd_body(self):
    for hist, x in zip(self.hist, self.state):
      hist.index_copy_(0, self.t, x[None])
    bf = self.buf
    new, r, bad = self.step_fn(tuple(self.state), bf["values"], bf["t0"],
                               bf["dt"], bf["params"], self.consts)
    self.costs.index_copy_(0, self.t, self._cost(r)[None])
    self.fails.index_copy_(0, self.t, bad[None])
    for buf, x in zip(self.state, new):
      buf.copy_(x)
    self.t.add_(1)

  def _close_body(self):
    """The final forward pass, its cost, and the reverse pass's seed: the
    final cost's cotangent on the last carry; then the step index is set
    to the last step."""
    for hist, x in zip(self.hist, self.state):
      hist[-1].copy_(x)
    time = self.state[-1]
    params = self.buf["params"]

    def final_cost(*diff):
      r, bad = self.final_fn(tuple(diff) + (time,), params, self.consts)
      return self._cost(r), bad

    cost, vjp_fn, bad = torch.func.vjp(final_cost, *self.state[:NDIFF],
                                       has_aux=True)
    self.costs[-1].copy_(cost)
    self.fails[-1].copy_(bad)
    for buf, g in zip(self.cbar, vjp_fn(self.inv_h)):
      buf.copy_(g)
    self.grad.zero_()
    self.t.fill_(self.horizon - 2)

  def _rev_body(self):
    state = [hist.index_select(0, self.t)[0] for hist in self.hist]
    time = state[-1]
    bf = self.buf

    def step(qpos, qvel, act, ctrl, values):
      new, r, _ = self.step_fn((qpos, qvel, act, ctrl, time), values,
                               bf["t0"], bf["dt"], bf["params"], self.consts)
      return tuple(new[:NDIFF]), self._cost(r)

    _, vjp_fn = torch.func.vjp(step, *state[:NDIFF], bf["values"])
    grads = vjp_fn((tuple(self.cbar), self.inv_h))
    for buf, g in zip(self.cbar, grads[:NDIFF]):
      buf.copy_(g)
    self.grad.add_(grads[NDIFF])
    self.t.sub_(1)

  def __call__(self, values, t0, dt, d0, params, cost_spec, mark=None):
    key = (tuple(values.shape), tuple(params.shape), cost_spec.norm_types,
           cost_spec.dims) + tuple(tuple(getattr(d0, f).shape)
                                   for f in rollout_lib.CARRY_FIELDS)
    if key != self.key:
      self._setup(values, t0, dt, d0, params, cost_spec)
      self.key = key
    for name, x in (("values", values), ("t0", t0), ("dt", dt),
                    ("params", params)):
      self.buf[name].copy_(x)
    for name in ("weights", "norm_params", "risk"):
      getattr(self.cs, name).copy_(getattr(cost_spec, name))
    for f in rollout_lib.CARRY_CONST:
      self.consts[f].copy_(getattr(d0, f))
    for buf, f in zip(self.state, STATE):
      buf.copy_(getattr(d0, f))
    self.t.zero_()
    for _ in range(self.horizon - 1):
      self.fwd()
    self.close()
    if mark is not None:
      mark("forward")
    for _ in range(self.horizon - 1):
      self.rev()
    if mark is not None:
      mark("reverse")
    failure = self.fails.any() | ~torch.isfinite(self.costs).all()
    value = torch.where(failure,
                        torch.full_like(self.inv_h,
                                        rollout_lib.MAX_RETURN_VALUE),
                        torch.sum(self.costs) / self.horizon)
    grad = torch.where(failure, torch.zeros_like(self.grad), self.grad)
    return value, grad, failure


def make_optimize_fn(m: Model, residual_fn_with_params, cost_spec,
                     config: GradientConfig):
  """`optimize(gen, d0, policy, residual_params, cost_spec, mark=None) ->
  (policy, info)`; `gen` is unused (the planner draws no noise).
  `optimize.routes` says which route each stage takes."""
  device = m.qpos0.device
  F.check_supported(m)
  horizon = config.horizon
  value_and_grad = ValueAndGrad(m, residual_fn_with_params, horizon,
                                config.interp)
  line_search = rollout_lib.StepLoop(m.replace(solve_route=S.SOLVE_KERNEL),
                                     residual_fn_with_params, horizon,
                                     config.interp)
  scorer = scoring.make_scorer(cost_spec, device)
  lo = m.actuator_ctrlrange[:, 0]
  hi = m.actuator_ctrlrange[:, 1]
  # steps scaled by the control range, so that they are dimensionless
  scale = 0.5 * torch.mean(hi - lo)
  steps = scale * torch.logspace(
      math.log10(config.step_max), math.log10(config.step_min),
      config.num_steps, dtype=torch.float32, device=device)

  def optimize(gen, d0, policy, residual_params, cost_spec, mark=None):
    del gen
    if mark is not None:
      mark("start")
    horizon_time = (horizon - 1) * m.opt.timestep
    policy = spline_lib.resample(policy, d0.time, horizon_time)
    ret0, grad, _ = value_and_grad(policy.values, policy.t0, policy.dt, d0,
                                   residual_params, cost_spec, mark=mark)
    # non-finite entries (a diverged rollout's) count as zero
    grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
    gnorm = torch.clamp(torch.sqrt(torch.sum(grad * grad)), min=1e-10)
    direction = -grad / gnorm
    candidates = policy.values[None] + steps[:, None, None] * direction[None]
    candidates = torch.minimum(torch.maximum(candidates, lo), hi)
    residuals, failure = line_search(candidates, policy.t0, policy.dt, d0,
                                     residual_params)
    returns = scorer(residuals.permute(1, 2, 0), cost_spec)
    failure = failure | ~torch.isfinite(returns)
    returns = torch.where(
        failure, torch.full_like(returns, rollout_lib.MAX_RETURN_VALUE),
        returns)
    if mark is not None:
      mark("line_search")
    # the best candidate by index_select: indexing with a tensor scalar
    # would read it back to the host
    best = torch.argmin(returns).reshape(1)
    best_return = returns.index_select(0, best)[0]
    improved = best_return < ret0
    new_values = torch.where(improved, candidates.index_select(0, best)[0],
                             policy.values)
    info = {"nominal_return": ret0,
            "best_return": torch.minimum(best_return, ret0),
            "grad_norm": gnorm, "improved": improved,
            "step": steps.index_select(0, best)[0], "returns": returns,
            "candidates": candidates}
    return policy.replace(values=new_values), info

  graphs = device.type == "cuda"
  optimize.routes = dict(
      value_and_grad="vjp_graphs" if graphs else "vjp_eager",
      line_search="pipeline_graph" if graphs else "pipeline",
      spd_solve=S.SOLVE_KERNEL, scoring=scorer.route)
  optimize.line_search = line_search
  return optimize


class GradientPlanner:
  """Host-side wrapper (reference GUI name: "Gradient") on `device`
  (default "cuda"; raises if that device is unavailable, or — naming what
  is missing — if the pipeline physics cannot step the planning model).
  `routes` says which route each stage takes."""

  def __init__(self, task, config: Optional[GradientConfig] = None,
               device="cuda"):
    self.device = check_device(device)
    if task.device != self.device:
      raise ValueError(f"task lives on {task.device}, planner asked for "
                       f"{self.device}")
    self.task = task
    self.m = getattr(task, "plan_model", task.model)
    self.config = config or make_config(task)
    self._optimize = make_optimize_fn(self.m, task.residual, task.cost_spec,
                                      self.config)
    self.routes = dict(self._optimize.routes)
    self.policy = sampling_lib.initial_policy(
        self.m, sampling_lib.SamplingConfig(
            num_spline_points=self.config.num_spline_points,
            interp=self.config.interp, horizon=self.config.horizon,
            exploration=(0.0, 0.0)), self.device)
    self.last_info = None

  def optimize(self, gen, d0, mark=None):
    self.policy, info = self._optimize(gen, d0, self.policy,
                                       self.task.residual_params,
                                       self.task.cost_spec, mark=mark)
    self.last_info = info
    return info

  def action(self, time) -> torch.Tensor:
    return sampling_lib.clip_ctrl(self.m,
                                  spline_lib.sample(self.policy, time))
