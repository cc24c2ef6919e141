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

On a CUDA device a step of the pipeline physics is thousands of small
operations, each a launch from the host. `GraphedBody` captures a function
of one step over static buffers as a CUDA graph and replays it, once a
step. `StepLoop` runs batched spline rollouts that way (the Gradient
planner's line search), and the Gradient planner's forward and reverse
passes (planners/gradient.py) are built on the same pieces
(`spline_step`).
"""

from __future__ import annotations

import dataclasses
import gc
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
CARRY_FIELDS = ("qpos", "qvel", "act", "ctrl", "time", "mocap_pos",
                 "mocap_quat", "userdata", "qfrc_applied", "xfrc_applied")
# what a step of a clean rollout changes, and what it only reads
CARRY_STATE = ("qpos", "qvel", "act", "ctrl", "time")
CARRY_CONST = ("mocap_pos", "mocap_quat", "userdata", "qfrc_applied",
               "xfrc_applied")


def pack_state(d: Data) -> torch.Tensor:
  """[qpos, qvel, act] packing."""
  return torch.cat([d.qpos, d.qvel, d.act])


def slim_carry(d: Data) -> dict:
  return {f: getattr(d, f) for f in CARRY_FIELDS}


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


class GraphedBody:
  """`body()` — a function of no arguments that reads and writes static
  tensors — as a CUDA graph on a CUDA device. The first call runs
  `body()` once on a side stream (which also sets up the libraries its
  operations use) and then captures it; every later call replays the
  graph (the first call's effect is the side stream's run: a capture
  runs nothing). On the CPU each call runs `body()`. A failed capture raises;
  nothing runs in its place. The kernel wrappers count the launches a
  replay makes themselves (ops/launches.py)."""

  def __init__(self, body: Callable, device):
    self.body = body
    self.cuda = torch.device(device).type == "cuda"
    self.graph = None

  def __call__(self):
    if not self.cuda:
      self.body()
      return
    if self.graph is not None:
      self.graph.replay()
      return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
      self.body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # no garbage collection during the capture: a collected CUDA graph (of
    # an object no longer used) resets itself, which a capture in progress
    # does not permit (it invalidates the capture)
    collecting = gc.isenabled()
    gc.disable()
    try:
      with torch.cuda.graph(graph):
        self.body()
    finally:
      if collecting:
        gc.enable()
    self.graph = graph


def copy_out(out):
  """A copy of fn's output (tensors, in tuples and records such as Data)
  that is the caller's to keep, not a graph's output buffers."""
  if isinstance(out, torch.Tensor):
    return out.clone()
  if isinstance(out, (tuple, list)):
    return type(out)(copy_out(v) for v in out)
  if dataclasses.is_dataclass(out):
    return type(out)(**{f.name: copy_out(getattr(out, f.name))
                        for f in dataclasses.fields(out)})
  return out


class GraphedFn:
  """`fn(*tensors)` over static buffers, through a `GraphedBody`: a CUDA
  graph on a CUDA device (captured at the first call, for that call's
  shapes), the function itself on the CPU. Each call copies its arguments
  into the input buffers, replays, and returns a copy of the output
  buffers (`copy_out`: tensors, tuples, records). `fn` must be a pure
  function of its arguments that makes no host synchronisation."""

  def __init__(self, fn: Callable, device):
    self.fn = fn
    self.cuda = torch.device(device).type == "cuda"
    self.body = None

  def _run(self):
    self.outputs = self.fn(*self.inputs)

  def __call__(self, *args):
    if not self.cuda:
      return self.fn(*args)
    first = self.body is None
    if first:
      self.inputs = [a.clone() for a in args]
      self.body = GraphedBody(self._run, self.inputs[0].device)
    for buf, a in zip(self.inputs, args):
      buf.copy_(a)
    self.body()
    if first:
      # the capture left the output buffers unwritten: a replay fills them
      self.body()
    return copy_out(self.outputs)


class StepGraph:
  """`physics.forward.step(m, d)` captured once as a CUDA graph and
  replayed for each step (a `GraphedFn` of the step over the carry
  fields): the agent's simulation step and the ground-truth estimator's.

  Eagerly one step of the pipeline physics is thousands of small device
  operations (Cartpole's RK4 step 13.7k, Swimmer's Euler step 4.8k: the
  fixed Newton iterations of the limit rows run whether a row is active or
  not), each a separate launch from the host. The graph replays them with
  one launch. The Data a step returns is a copy, the caller's to keep.
  Captured on the first call, for the shapes of that Data."""

  def __init__(self, m: Model):
    self.m = m
    self.graph = GraphedFn(self._step, m.qpos0.device)

  def _step(self, *state):
    return F.step(self.m, Data(**dict(zip(CARRY_FIELDS, state))))

  def __call__(self, d: Data) -> Data:
    return self.graph(*(getattr(d, f) for f in CARRY_FIELDS))


def spline_step(m: Model, residual_fn_with_params: Callable, interp: int):
  """One step of a clean spline rollout on one Data, as functions of
  tensors (what `vmap`, `torch.func.vjp` and a graph capture trace):

    step(state, values, t0, dt, params, consts) -> (state', residual,
        diverged)
    final(state, params, consts) -> (residual, diverged)

  `state` is the CARRY_STATE tuple, `consts` the CARRY_CONST fields by
  name; `step` samples the spline (values, t0, dt) at the state's time,
  clips, runs forward, records the residual and integrates (the state's
  ctrl becomes the applied control), as `rollout` does; `final` is the
  closing forward pass."""
  lo = m.actuator_ctrlrange[:, 0]
  hi = m.actuator_ctrlrange[:, 1]

  def data(state, consts):
    return Data(**dict(zip(CARRY_STATE, state)), **consts)

  def step(state, values, t0, dt, params, consts):
    d = data(state, consts)
    pol = spline_lib.SplinePolicy(t0=t0, dt=dt, values=values, interp=interp)
    u = torch.minimum(torch.maximum(spline_lib.sample(pol, d.time), lo), hi)
    d = F.forward(m, d.replace(ctrl=u))
    r = residual_fn_with_params(m, d, params)
    d = F.integrate(m, d)
    return (d.qpos, d.qvel, d.act, u, d.time), r, _diverged(d)

  def final(state, params, consts):
    d = F.forward(m, data(state, consts))
    return residual_fn_with_params(m, d, params), _diverged(d)

  return step, final


class StepLoop:
  """B clean spline rollouts over the horizon as one function of one
  batched step (`torch.func.vmap` of `spline_step`) over static buffers,
  run H-1 times and closed by the final forward pass: on a CUDA device
  each is a `GraphedBody` (captured at the first call, replayed after;
  captured anew when the shapes change). The step index lives on the
  device, so no step reads anything back to the host. Returns
  (residuals (B, T, nr), failure (B,))."""

  def __init__(self, m: Model, residual_fn_with_params: Callable,
               horizon: int, interp: int):
    self.m, self.horizon = m, horizon
    self.step_fn, self.final_fn = spline_step(m, residual_fn_with_params,
                                              interp)
    self.key = None

  def _setup(self, values, t0, dt, d0, params):
    b = values.shape[0]
    dev = values.device
    self.buf = dict(values=values.clone(), t0=t0.clone(), dt=dt.clone(),
                    params=params.clone())
    self.consts = {f: getattr(d0, f).clone() for f in CARRY_CONST}
    self.state = [getattr(d0, f)[None].repeat(b, *([1] * getattr(
        d0, f).dim())).clone() for f in CARRY_STATE]
    r, _ = self.final_fn(tuple(getattr(d0, f) for f in CARRY_STATE),
                         params, self.consts)
    self.residuals = torch.zeros((b, self.horizon, r.shape[-1]),
                                 dtype=r.dtype, device=dev)
    self.fails = torch.zeros((b, self.horizon), dtype=torch.bool,
                             device=dev)
    self.t = torch.zeros((1,), dtype=torch.long, device=dev)
    self.step = GraphedBody(self._step_body, dev)
    self.final = GraphedBody(self._final_body, dev)

  def _step_body(self):
    bf = self.buf
    new, r, bad = torch.func.vmap(
        self.step_fn, in_dims=(0, 0, None, None, None, None))(
            tuple(self.state), bf["values"], bf["t0"], bf["dt"],
            bf["params"], self.consts)
    self.residuals.index_copy_(1, self.t, r[:, None])
    self.fails.index_copy_(1, self.t, bad[:, None])
    for buf, x in zip(self.state, new):
      buf.copy_(x)
    self.t.add_(1)

  def _final_body(self):
    r, bad = torch.func.vmap(self.final_fn, in_dims=(0, None, None))(
        tuple(self.state), self.buf["params"], self.consts)
    self.residuals[:, -1].copy_(r)
    self.fails[:, -1].copy_(bad)

  def __call__(self, values, t0, dt, d0, params):
    key = (tuple(values.shape), tuple(params.shape)) + tuple(
        tuple(getattr(d0, f).shape) for f in CARRY_FIELDS)
    if key != self.key:
      self._setup(values, t0, dt, d0, params)
      self.key = key
    for name, x in (("values", values), ("t0", t0), ("dt", dt),
                    ("params", params)):
      self.buf[name].copy_(x)
    for f in CARRY_CONST:
      self.consts[f].copy_(getattr(d0, f))
    for buf, f in zip(self.state, CARRY_STATE):
      buf.copy_(getattr(d0, f)[None].expand_as(buf))
    self.t.zero_()
    for _ in range(self.horizon - 1):
      self.step()
    self.final()
    return self.residuals.clone(), self.fails.any(dim=1)


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
