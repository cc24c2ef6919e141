"""iLQG planner.

Semantics (those of the JAX package's planners/ilqg.py, which follows
mjpc/planners/ilqg/):
  * nominal trajectory from a parallel line search over FEEDBACK SCALING:
    rollouts of u = u_nom + s*K*(x - x_nom) at log-scaled s (last = 0), the
    best becomes the nominal;
  * dynamics + Gauss-Newton cost derivatives along the trajectory by
    forward-mode AD (planners/derivatives.py);
  * backward Riccati recursion with FOUR regularization types — control
    (Quu + mu I), state-control (Quu + mu B'B, Qxu + mu A'B), value
    (Vxx + mu I inside the Q expansion), none — and a box QP at every step
    for the control limits (projected Newton on the free set; feedback rows
    of clamped controls are zero);
  * parallel line search over action-improvement scalings: rollouts of
    u = u_nom + alpha*k + K*(x - x_nom) at log-scaled alphas with a final
    alpha = 0 candidate;
  * actual-vs-expected improvement ("surprise" z = clip(improvement /
    expected, 0, 2), expected = -alpha*(dV0 + alpha*dV1)) drives the
    regularization schedule with a compounding rate.

On a CUDA device the backward sweep is ONE launch of the hand-written
Riccati kernel (ops/riccati_lane.py), and both line searches are one launch
each of the lane rollout kernel in its feedback mode (ops/step_lane.py).
`backward_pass` below is the plain PyTorch version of the Riccati kernel and
the vmapped pipeline `feedback_rollout` that of the line searches: the CPU's
routes. On a CUDA device they run only when the caller asks for them by name
(`riccati_lane_mode=False`, `lane=False`); a model or size that a kernel
refuses raises `NotImplementedError` there instead of giving way silently.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.planners import derivatives as deriv

# the routes a stage of the iteration can take (`optimize.routes`,
# `ILQGPlanner.routes`)
ROUTE_KERNEL = "kernel"
ROUTE_PLAIN = "plain"


def _on_card(device) -> bool:
  """Whether tensors of this device must go through the CUDA kernels."""
  return torch.device(device).type == "cuda"


# regularization types (reference settings.h: regularization_type)
REG_CONTROL = 0
REG_STATE_CONTROL = 1
REG_VALUE = 2
REG_NONE = 3


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
  horizon: int = 50
  num_alphas: int = 8
  boxqp_iters: int = 6
  reg_initial: float = 1e-2
  reg_min: float = 1e-6
  reg_max: float = 1e6
  reg_factor: float = 10.0
  max_reg_retries: int = 4
  reg_type: int = REG_CONTROL
  min_linesearch_step: float = 1e-3
  nominal_feedback_scaling: bool = True
  num_fb_scales: int = 4
  # evaluate dynamics Jacobians every (skip)-th step, linearly interpolate
  # between
  derivative_skip: int = 1

  def replace(self, **kw) -> "ILQGConfig":
    return dataclasses.replace(self, **kw)


def make_config(task) -> ILQGConfig:
  horizon_time = task.config("agent_horizon", 1.0)
  agent_timestep = task.config("agent_timestep",
                               float(task.model.opt.timestep))
  return ILQGConfig(
      horizon=int(round(horizon_time / agent_timestep)) + 1,
      num_alphas=int(task.config("ilqg_num_rollouts", 8)),
      reg_type=int(task.config("ilqg_regularization_type", REG_CONTROL)),
      derivative_skip=max(1, int(task.config("derivative_skip", 0)) + 1),
  )


@dataclasses.dataclass(frozen=True)
class ILQGPolicy:
  """Nominal trajectory + time-indexed feedback gains."""
  states: torch.Tensor    # (T, nstate)
  actions: torch.Tensor   # (T, nu)
  times: torch.Tensor     # (T,)
  gains: torch.Tensor     # (T, nu, ndx)
  reg: torch.Tensor       # regularization carried across iterations
  reg_rate: torch.Tensor  # compounding rate

  def replace(self, **kw) -> "ILQGPolicy":
    return dataclasses.replace(self, **kw)


def _boxqp(quu, qu, lower, upper, iters: int):
  """Fixed-iteration projected-Newton box QP.

  min 0.5 du' Quu du + qu' du  s.t.  lower <= du <= upper.
  Returns (du, free, free_solve) where free_solve(free, rhs) solves the
  free-set system (clamped rows zero).
  """
  nu = qu.shape[0]
  eye = torch.eye(nu, dtype=qu.dtype, device=qu.device)

  def free_solve(free, rhs):
    """Solve Quu_ff x_f = rhs_f with clamped rows forced to zero, by
    Gauss-Jordan without pivoting: the masked matrix is SPD with unit
    diagonal on clamped rows, so the pivots are bounded away from zero."""
    fmask = free.to(qu.dtype)
    quu_m = quu * fmask[:, None] * fmask[None, :] + \
        torch.diag(1.0 - fmask) + 1e-9 * eye
    r2 = rhs[:, None] if rhs.ndim == 1 else rhs
    aug = torch.cat([quu_m, r2 * fmask[:, None]], dim=1)
    for i in range(nu):
      row = aug[i] / aug[i, i]
      aug = aug - aug[:, i:i + 1] * row[None, :]
      aug = torch.cat([aug[:i], row[None, :], aug[i + 1:]], dim=0)
    x = aug[:, nu:] * fmask[:, None]
    return x[:, 0] if rhs.ndim == 1 else x

  def free_set(du):
    grad = qu + quu @ du
    at_lower = (du <= lower + 1e-9) & (grad > 0)
    at_upper = (du >= upper - 1e-9) & (grad < 0)
    return ~(at_lower | at_upper)

  du = torch.minimum(torch.maximum(
      -qu / torch.clamp(torch.diagonal(quu), min=1e-8), lower), upper)
  for _ in range(iters):
    free = free_set(du)
    # Newton step on the free set, with clamped contribution in the rhs
    clamped_du = torch.where(free, torch.zeros_like(du), du)
    rhs = qu + quu @ clamped_du
    step = -free_solve(free, rhs)
    du = torch.minimum(torch.maximum(torch.where(free, step, du), lower),
                       upper)
  return du, free_set(du), free_solve


def backward_pass(a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg,
                  boxqp_iters: int, reg_type: int = REG_CONTROL):
  """Riccati recursion with selectable regularization type; the plain
  PyTorch version of the Riccati kernel (ops/riccati_lane.py).

  a,b: (T-1, ...); cost expansions: (T, ...). Returns k (T-1, nu),
  K (T-1, nu, ndx), dv = (dv1, dv2), ok flag (0-d bool tensor).
  """
  t_end = cx.shape[0] - 1
  nu = cu.shape[-1]
  nx = cx.shape[-1]
  eye_u = torch.eye(nu, dtype=cu.dtype, device=cu.device)
  eye_x = torch.eye(nx, dtype=cu.dtype, device=cu.device)
  vx, vxx = cx[t_end], cxx[t_end]
  ks, kmats = [None] * t_end, [None] * t_end
  dv1 = torch.zeros((), dtype=cu.dtype, device=cu.device)
  dv2 = torch.zeros((), dtype=cu.dtype, device=cu.device)
  bad = torch.zeros((), dtype=torch.bool, device=cu.device)
  for t in range(t_end - 1, -1, -1):
    at, bt = a[t], b[t]
    qx = cx[t] + at.T @ vx
    qu = cu[t] + bt.T @ vx
    qxx = cxx[t] + at.T @ vxx @ at
    qux = cxu[t].T + bt.T @ vxx @ at      # (nu, ndx)
    quu = cuu[t] + bt.T @ vxx @ bt

    # ---- regularized copies used for the gain/step solves ----
    if reg_type == REG_VALUE:
      vxx_reg = vxx + reg * eye_x
      qux_reg = cxu[t].T + bt.T @ vxx_reg @ at
      quu_reg = cuu[t] + bt.T @ vxx_reg @ bt
    elif reg_type == REG_CONTROL:
      qux_reg = qux
      quu_reg = quu + reg * eye_u
    elif reg_type == REG_STATE_CONTROL:
      qux_reg = qux + reg * (bt.T @ at)
      quu_reg = quu + reg * (bt.T @ bt)
    else:  # REG_NONE
      qux_reg = qux
      quu_reg = quu + 1e-9 * eye_u

    k, free, solve = _boxqp(quu_reg, qu, du_lower[t], du_upper[t],
                            boxqp_iters)
    kmat = -solve(free, qux_reg)  # (nu, ndx), clamped rows zero

    # cost-to-go update uses the UNregularized expansions
    vx_new = qx + kmat.T @ (quu @ k + qu) + qux.T @ k
    vxx_new = qxx + kmat.T @ quu @ kmat + kmat.T @ qux + qux.T @ kmat
    vxx_new = 0.5 * (vxx_new + vxx_new.T)
    dv1 = dv1 + k @ qu
    dv2 = dv2 + 0.5 * (k @ quu @ k)
    bad = bad | ~torch.isfinite(vx_new).all() | ~torch.isfinite(k).all()
    vx, vxx = vx_new, vxx_new
    ks[t], kmats[t] = k, kmat
  return torch.stack(ks), torch.stack(kmats), (dv1, dv2), ~bad


def scale_regularization(reg, rate, factor, reg_min, reg_max):
  """The rate compounds so repeated increases / decreases accelerate."""
  rate_new = torch.where(factor > 1.0,
                         torch.maximum(rate * factor, factor),
                         torch.minimum(rate * factor, factor))
  reg_new = torch.clamp(reg * rate_new, reg_min, reg_max)
  return reg_new, rate_new


def update_regularization(reg, rate, factor, reg_min, reg_max, z, s):
  """Surprise z and step size s pick the scale."""
  factor = torch.as_tensor(factor, dtype=reg.dtype, device=reg.device)
  one = torch.ones_like(factor)
  bad = ~torch.isfinite(z) | ~torch.isfinite(s)
  good = (z > 0.5) | (s > 0.3)
  poor = (z < 0.1) | (s < 0.06)
  factor_eff = torch.where(
      bad, factor * factor,
      torch.where(good, 1.0 / factor, torch.where(poor, factor, one)))
  reg_new, rate_new = scale_regularization(reg, rate, factor_eff, reg_min,
                                           reg_max)
  keep = factor_eff == 1.0
  return torch.where(keep, reg, reg_new), torch.where(keep, rate, rate_new)


def _make_lane_feedback(m: Model, lane_spec, horizon: int):
  """Lane-kernel feedback rollouts: the whole K-candidate line search
  (u = u_nom + alpha k + s K dx per step) runs inside ONE launch of the
  rollout kernel in its feedback mode — one thread per candidate, the
  horizon inside the kernel — instead of K vmapped pipeline rollouts whose
  per-step launch overhead dominates at robotics sizes.

  The nominal trajectory, k and the gains ride the per-step table shared by
  all candidates; alpha / scale are the per-candidate values rows.
  """
  from mujoco_mpc_tpu_torch.ops import step_lane

  nq, nv, nu = m.nq, m.nv, m.nu
  nx = deriv.ndx(m)
  if m.na != 0:
    raise ValueError("activation states do not ride the lane kernel")
  naux0 = max(int(lane_spec["naux"]), 1)
  lo = m.actuator_ctrlrange[:, 0]
  hi = m.actuator_ctrlrange[:, 1]
  kernel = step_lane.build_rollout_kernel(
      m, horizon, 1, contact_geoms=lane_spec.get("contact_geoms"),
      residual=lane_spec,
      naux=naux0, record_states=True, feedback=True)
  make_aux = lane_spec["make_aux"]

  def rollouts(d0, pol_states, pol_actions, ks, kmats, alphas, scales,
               residual_params, cs):
    """(K candidates) -> states (K,H,nq+nv), actions (K,H,nu),
    returns (K,). Mirrors feedback_rollout vmapped over candidates."""
    kc = alphas.shape[0]
    dtype, dev = pol_actions.dtype, pol_actions.device
    values = torch.stack([alphas, scales]).contiguous()
    qpos0 = d0.qpos.to(dtype)[:, None].repeat(1, kc)
    qvel0 = d0.qvel.to(dtype)[:, None].repeat(1, kc)
    aux0 = torch.zeros((naux0,), dtype=dtype, device=dev)
    if lane_spec["naux"] > 0:
      aux0 = make_aux(d0, residual_params).to(dtype)
    aux = aux0[:, None].repeat(1, kc)
    # per-step blocks: u_nom, k, K (row-major), x_nom — the final block
    # pads k / K with zeros (the pipeline's appended last action)
    k_pad = torch.cat([ks, torch.zeros((1, nu), dtype=dtype, device=dev)])
    km_pad = torch.cat(
        [kmats, torch.zeros((1, nu, nx), dtype=dtype, device=dev)])
    blocks = torch.cat([pol_actions, k_pad, km_pad.reshape(horizon, nu * nx),
                        pol_states.to(dtype)], dim=1)        # (H, stride)
    out = kernel(qpos0, qvel0, values, aux,
                 blocks.reshape(-1).contiguous())      # (H, nq+nv+nr, kc)
    states = out[:, :nq + nv].permute(2, 0, 1)          # (K,H,S)
    res = out[:, nq + nv:].permute(2, 0, 1)             # (K,H,nr)
    costs = cs.cost(res)                                # (K,H)
    ok = torch.isfinite(states).all(dim=2).all(dim=1) & \
        (torch.abs(states).amax(dim=(1, 2)) < 1e7) & \
        torch.isfinite(costs).all(dim=1)
    totals = torch.where(
        ok, torch.sum(costs, dim=1) / horizon,
        torch.full_like(costs[:, 0], rollout_lib.MAX_RETURN_VALUE))
    # executed actions, recomputed from the recorded states (the kernel
    # records states + residuals) — tangent state_diff, NOT subtraction
    # (quaternion joints)
    dx = deriv.state_diff(m, states, pol_states.to(dtype)[None])
    u_fb = torch.einsum("tux,ktx->ktu", km_pad, dx)
    u_all = (pol_actions[None] + alphas[:, None, None] * k_pad[None]
             + scales[:, None, None] * u_fb)
    actions = torch.minimum(torch.maximum(u_all, lo), hi)
    return states, actions, totals

  return rollouts


def make_optimize_fn(m: Model, residual_fn, cost_fn, cost_spec,
                     config: ILQGConfig, residual_fn_with_params=None,
                     lane_spec=None,
                     riccati_lane_mode: Optional[bool] = None):
  """Returns optimize(key, d0, policy, residual_params=None, cost_spec=None,
  mark=None) -> (new policy, info).

  `lane_spec` (a task's lane residual spec) routes both line searches
  through the lane rollout kernel; False asks for the vmapped pipeline
  rollouts; None takes them on the CPU and raises on a CUDA device.
  `riccati_lane_mode` routes the backward sweep through the Riccati kernel:
  True, or None on a CUDA device, builds the kernel and raises
  `NotImplementedError` when the sizes are outside its gate; False, or None
  on the CPU, takes the plain `backward_pass`. `optimize.routes` says which
  route each stage took.

  `info["host_readbacks"]` counts the device-to-host reads the iteration
  made (the retry loop's `ok`). `mark`, when given, is called with the name
  of each stage as that stage's work has been enqueued ("start",
  "nominal_line_search", "derivatives", "backward", "action_line_search"):
  the hook for a caller that times the stages."""
  from mujoco_mpc_tpu_torch.ops import riccati_lane

  horizon = config.horizon
  nx = deriv.ndx(m)
  lo_ctrl = m.actuator_ctrlrange[:, 0]
  hi_ctrl = m.actuator_ctrlrange[:, 1]
  cost_spec_default = cost_spec
  on_card = _on_card(m.qpos0.device)
  lane_fb = None
  if lane_spec is None and on_card:
    raise NotImplementedError(
        "iLQG line searches on a CUDA device need a lane residual spec "
        "(lane_spec); pass lane_spec=False to take the vmapped pipeline "
        "rollouts there")
  if lane_spec:
    lane_fb = _make_lane_feedback(m, lane_spec, horizon)

  # backward pass: one launch of the Riccati kernel (ops/riccati_lane.py),
  # or the plain Python loop
  if riccati_lane_mode is None:
    riccati_lane_mode = on_card
  if riccati_lane_mode and not riccati_lane.supports(nx, m.nu, horizon):
    raise NotImplementedError(
        f"sizes outside the Riccati kernel's gate: ndx={nx} (<=128), "
        f"nu={m.nu} (1..32), horizon={horizon} (2..512); pass "
        "riccati_lane_mode=False to take the plain backward pass")
  routes = dict(
      line_search=ROUTE_KERNEL if lane_fb is not None else ROUTE_PLAIN,
      backward=ROUTE_KERNEL if riccati_lane_mode else ROUTE_PLAIN)
  # one build-time log line so users can see which routes a model took
  logging.getLogger(__name__).info(
      "iLQG routes: backward pass %s, line searches %s (ndx=%d nu=%d "
      "horizon=%d, device %s)", routes["backward"], routes["line_search"],
      nx, m.nu, horizon, m.qpos0.device)
  if riccati_lane_mode:
    backward = riccati_lane.build_backward_kernel(
        nx, m.nu, horizon, config.boxqp_iters, config.reg_type)
  else:
    def backward(a, b, cx, cu, cxx, cxu, cuu, lo, hi, reg):
      return backward_pass(a, b, cx, cu, cxx, cxu, cuu, lo, hi, reg,
                           config.boxqp_iters, config.reg_type)

  def feedback_rollout(rf, cf, d0, pol_states, pol_actions, ks, kmats,
                       alpha, fb_scale):
    """Pipeline rollout of
    u_t = clamp(u_nom_t + alpha k_t + fb_scale K_t (x - x_nom_t))."""
    d = d0
    states, actions, residuals, fails = [], [], [], []
    for t in range(horizon - 1):
      state = rollout_lib.pack_state(d)
      dx = deriv.state_diff(m, state, pol_states[t])
      u = pol_actions[t] + alpha * ks[t] + fb_scale * (kmats[t] @ dx)
      u = torch.minimum(torch.maximum(u, lo_ctrl), hi_ctrl)
      d = F.forward(m, d.replace(ctrl=u))
      r = rf(m, d)  # pre-integration residual
      d = rollout_lib.from_carry(rollout_lib.slim_carry(F.integrate(m, d)))
      states.append(state)
      actions.append(u)
      residuals.append(r)
      fails.append(rollout_lib._diverged(d))
    d_final = F.forward(m, d)
    states.append(rollout_lib.pack_state(d_final))
    actions.append(actions[-1])
    residuals.append(rf(m, d_final))
    costs = cf(torch.stack(residuals))
    failure = torch.stack(fails).any() | ~torch.isfinite(costs).all()
    total = torch.where(
        failure, torch.full_like(costs[0], rollout_lib.MAX_RETURN_VALUE),
        torch.sum(costs) / horizon)
    return torch.stack(states), torch.stack(actions), total

  def optimize(key, d0, policy: ILQGPolicy, residual_params=None,
               cost_spec=None, mark=None):
    del key
    if mark is None:
      mark = lambda stage: None
    if residual_params is not None and residual_fn_with_params is not None:
      rf = lambda mm, dd: residual_fn_with_params(mm, dd, residual_params)
    else:
      rf = residual_fn
    cs = cost_spec if cost_spec is not None else cost_spec_default
    cf = cs.cost
    dtype, dev = policy.actions.dtype, policy.actions.device
    template = d0
    readbacks = 0
    mark("start")

    # 1. nominal trajectory: line search over feedback scaling —
    #    log-scaled scales with a final 0 (pure feedforward replay)
    zero_k = torch.zeros_like(policy.actions[:-1])

    def batch_rollouts(pol_states, pol_actions, ks, kmats, alphas, scales):
      """K feedback rollouts: the lane kernel (one launch, one thread per
      candidate) when available, else vmapped pipeline rollouts."""
      if lane_fb is not None:
        return lane_fb(d0, pol_states, pol_actions, ks, kmats, alphas,
                       scales, residual_params, cs)
      return torch.func.vmap(
          lambda al, s: feedback_rollout(rf, cf, d0, pol_states,
                                         pol_actions, ks, kmats, al, s))(
              alphas, scales)

    def logscale(n):
      return torch.cat([
          torch.logspace(0.0, float(np.log10(config.min_linesearch_step)),
                         n - 1, dtype=dtype, device=dev),
          torch.zeros((1,), dtype=dtype, device=dev)])

    if config.nominal_feedback_scaling and config.num_fb_scales > 1:
      n_s = config.num_fb_scales
      fb_scales = logscale(n_s)
      nom_states, nom_actions, nom_returns = batch_rollouts(
          policy.states, policy.actions, zero_k, policy.gains[:-1],
          torch.zeros((n_s,), dtype=dtype, device=dev), fb_scales)
      best_nom = torch.argmin(nom_returns).reshape(1)
      states = nom_states.index_select(0, best_nom)[0]
      actions = nom_actions.index_select(0, best_nom)[0]
      nominal_return = nom_returns.index_select(0, best_nom)[0]
      feedback_scaling = fb_scales.index_select(0, best_nom)[0]
    else:
      nom_states, nom_actions, nom_returns = batch_rollouts(
          policy.states, policy.actions, zero_k, policy.gains[:-1],
          torch.zeros((1,), dtype=dtype, device=dev),
          torch.ones((1,), dtype=dtype, device=dev))
      states, actions = nom_states[0], nom_actions[0]
      nominal_return = nom_returns[0]
      feedback_scaling = torch.ones((), dtype=dtype, device=dev)
    times = template.time + m.opt.timestep * torch.arange(
        horizon, dtype=dtype, device=dev)
    mark("nominal_line_search")

    # 2. derivatives along the nominal — fused model+cost AD sweep
    a, b, cx, cu, cxx, cxu, cuu = deriv.trajectory_derivatives(
        m, template, rf, cs, states, actions, times,
        skip=config.derivative_skip)
    mark("derivatives")

    # 3. backward pass with regularization escalation on failure: `ok` is
    #    read back on the host after every sweep (one read per sweep)
    du_lower = lo_ctrl[None] - actions[:-1]
    du_upper = hi_ctrl[None] - actions[:-1]
    reg = policy.reg
    ks, kmats, (dv1, dv2), ok = backward(
        a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg)
    readbacks += 1
    tries = 0
    while not bool(ok) and tries < config.max_reg_retries:
      reg = torch.clamp(reg * config.reg_factor, max=config.reg_max)
      ks, kmats, (dv1, dv2), ok = backward(
          a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg)
      readbacks += 1
      tries += 1
    mark("backward")

    # 4. parallel line search over log-scaled alphas + a final alpha = 0
    alphas = logscale(config.num_alphas)
    ls_states, ls_actions, ls_returns = batch_rollouts(
        states, actions, ks, kmats, alphas,
        torch.ones((config.num_alphas,), dtype=dtype, device=dev))
    mark("action_line_search")
    best = torch.argmin(ls_returns).reshape(1)
    best_return = ls_returns.index_select(0, best)[0]
    improved = best_return < nominal_return
    new_states = torch.where(improved, ls_states.index_select(0, best)[0],
                             states)
    new_actions = torch.where(improved, ls_actions.index_select(0, best)[0],
                              actions)

    # 5. surprise-driven regularization schedule:
    #    expected = -alpha*(dV0 + alpha*dV1), z = clip(improve/expected, 0, 2)
    action_step = alphas.index_select(0, best)[0]
    expected = -action_step * (dv1 + action_step * dv2) + 1e-16
    improvement = nominal_return - best_return
    surprise = torch.clamp(improvement / expected, 0.0, 2.0)
    new_reg, new_rate = update_regularization(
        reg, policy.reg_rate, config.reg_factor, config.reg_min,
        config.reg_max, surprise, action_step)

    gains = torch.cat([kmats, kmats[-1:]], dim=0)
    new_policy = ILQGPolicy(
        states=new_states, actions=new_actions, times=times, gains=gains,
        reg=new_reg, reg_rate=new_rate)
    info = {
        "nominal_return": nominal_return,
        "best_return": torch.minimum(best_return, nominal_return),
        "alpha": action_step,
        "improved": improved,
        "backward_ok": ok,
        "reg": new_reg,
        "surprise": surprise,
        "expected": expected,
        "feedback_scaling": feedback_scaling,
        "backward_sweeps": 1 + tries,
        "host_readbacks": readbacks,
    }
    return new_policy, info

  optimize.routes = routes
  return optimize


def initial_policy(m: Model, config: ILQGConfig, d0: Data,
                   dtype=torch.float32) -> ILQGPolicy:
  t = config.horizon
  dev = d0.qpos.device
  state0 = torch.cat([d0.qpos, d0.qvel, d0.act]).to(dtype)
  return ILQGPolicy(
      states=state0[None].repeat(t, 1),
      actions=torch.zeros((t, m.nu), dtype=dtype, device=dev),
      times=torch.zeros((t,), dtype=dtype, device=dev),
      gains=torch.zeros((t, m.nu, deriv.ndx(m)), dtype=dtype, device=dev),
      reg=torch.tensor(config.reg_initial, dtype=dtype, device=dev),
      reg_rate=torch.ones((), dtype=dtype, device=dev))


class ILQGPlanner:
  """Host-side wrapper (reference GUI name: "iLQG").

  `lane` routes the line searches through the lane rollout kernel: True,
  or None on a CUDA device, takes it (on the CPU through the kernel's plain
  version) and raises `NotImplementedError` naming the gate when the task
  or model is outside the kernel's class; False, or None on the CPU, takes
  the vmapped pipeline rollouts. `riccati_lane_mode` does the same for the
  backward sweep and the Riccati kernel. `routes` says which route each
  stage took ("kernel" or "plain").
  """

  def __init__(self, task, config: Optional[ILQGConfig] = None,
               dtype=torch.float32, lane: Optional[bool] = None,
               riccati_lane_mode: Optional[bool] = None, device="cuda"):
    self.device = model_lib.check_device(device)
    if task.device != self.device:
      raise ValueError(f"task lives on {task.device}, planner asked for "
                       f"{self.device}")
    self.task = task
    self.m = getattr(task, "plan_model", task.model)
    self.config = config or make_config(task)
    residual_fn = lambda m, d: task.residual(m, d, task.residual_params)
    self.lane_spec = self._lane_spec(task, lane)
    self._optimize = make_optimize_fn(
        self.m, residual_fn, task.cost_spec.cost, task.cost_spec,
        self.config, residual_fn_with_params=task.residual,
        lane_spec=self.lane_spec or False,
        riccati_lane_mode=riccati_lane_mode)
    self.routes = dict(self._optimize.routes)
    self.policy = initial_policy(self.m, self.config, task.make_data(),
                                 dtype)
    self.last_info = None

  def _lane_spec(self, task, lane):
    """The task's lane residual spec when the line searches ride the lane
    kernel, None when the caller chose the pipeline rollouts; raises when
    the kernel was asked for (or is the device's only route) and a gate
    refuses."""
    if lane is None:
      lane = _on_card(self.device)
    if not lane:
      return None
    from mujoco_mpc_tpu_torch.ops import step_lane
    m = self.m
    contact_geoms = getattr(task, "plan_contact_geoms", None)
    lane_modes = getattr(task, "lane_modes", None)
    refused = None
    if not hasattr(task, "lane_residual_spec"):
      refused = (f"task {type(task).__name__} has no lane_residual_spec "
                 "(its residual is not written for the rollout kernel)")
    elif m.na != 0:
      refused = f"the model has activation states (na={m.na})"
    elif not step_lane.supports(m, ground_only=True,
                                contact_geoms=contact_geoms):
      refused = "the model is outside the rollout kernel's class " \
          "(step_lane.supports)"
    elif lane_modes is not None and int(task.mode) not in lane_modes:
      refused = (f"task mode {int(task.mode)} is not among the modes its "
                 f"lane residual covers {tuple(lane_modes)}")
    if refused is not None:
      raise NotImplementedError(
          f"iLQG line searches cannot take the lane rollout kernel: "
          f"{refused}; pass lane=False to take the vmapped pipeline "
          "rollouts")
    spec = dict(task.lane_residual_spec())
    spec["contact_geoms"] = contact_geoms
    return spec

  def optimize(self, key, d0: Data, mark=None):
    self.policy, info = self._optimize(key, d0, self.policy,
                                       self.task.residual_params,
                                       self.task.cost_spec, mark=mark)
    self.last_info = info
    return info

  def action(self, time, state=None) -> torch.Tensor:
    """Nominal + feedback action at query time."""
    pol = self.policy
    t = torch.as_tensor(time, dtype=pol.times.dtype, device=pol.times.device)
    idx = torch.clamp(
        torch.searchsorted(pol.times, t.reshape(1), right=True) - 1, 0,
        pol.times.shape[0] - 1)
    u = pol.actions.index_select(0, idx)[0]
    if state is not None:
      state = torch.as_tensor(state, dtype=u.dtype, device=u.device)
      dx = deriv.state_diff(self.m, state, pol.states.index_select(0, idx)[0])
      u = u + pol.gains.index_select(0, idx)[0] @ dx
    return torch.minimum(torch.maximum(u, self.m.actuator_ctrlrange[:, 0]),
                         self.m.actuator_ctrlrange[:, 1])
