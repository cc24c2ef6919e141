"""Direct trajectory optimizer: batch smoothing and system identification
over configurations through inverse dynamics, as the JAX package's
direct/optimizer.py (reference mjpc/direct/direct.{h,cc}).

Optimise q_{0:T} so that (a) the sensors predicted from (q, v, a) match the
measured ones and (b) inverse dynamics matches the applied force; v and a
come from finite differences of the configurations; the cost is
Gauss-Newton with per-sensor and per-force weights.

Two regimes:
  * dense (short windows): the stacked residual's Jacobian over the whole
    configuration tangent, one dense Cholesky of the (T*nv)^2 system;
  * banded (`banded=True`, the default at horizon >= 24): per-stage
    Jacobian blocks with respect to (q_{t-1}, q_t, q_{t+1}) from one
    vmapped Jacobian over a 3*nv tangent, and the square-root solve of
    direct/banded.py. Parameter estimation keeps its dense border.

The Jacobians come from `torch.func.jacrev` where the JAX package uses
forward mode (jax.jacfwd): the same matrices to rounding, at about half
the host time on the CPU (estimators/kalman.py says why).

The solve is three pure functions of tensors: the start (the initial
cost), one Gauss-Newton iteration (which also returns the loop's
condition for the next one, and the cost), and the close (the final
configurations and status). On a CUDA device each is one CUDA graph
(`rollout.GraphedFn`). The host runs the loop of the JAX package's
`lax.while_loop`: it replays the iteration while the condition holds,
reading the condition and the cost back after each (one read an
iteration), so the CPU and the card run the same loop and stop at the
same iteration. Statuses mirror direct.h:36-45.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacrev, vmap

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.direct import banded as band_lib
from mujoco_mpc_tpu_torch.estimators.base import HostUpload
from mujoco_mpc_tpu_torch.estimators.kalman import cho_solve
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import inverse as inv_lib
from mujoco_mpc_tpu_torch.physics import sensors as sensors_lib
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import derivatives as deriv


class Status(enum.IntEnum):
  """(reference direct.h:36-45)"""
  UNSOLVED = 0
  SOLVED = 1
  MAX_ITERATIONS_FAILURE = 2
  SMALL_DIRECTION_FAILURE = 3
  MAX_REGULARIZATION_FAILURE = 4
  COST_DIFFERENCE_FAILURE = 5
  EXPECTED_DECREASE_FAILURE = 6


@dataclasses.dataclass(frozen=True)
class DirectSettings:
  max_iterations: int = 12
  ls_iterations: int = 8
  gradient_tolerance: float = 1e-6
  cost_tolerance: float = 1e-8
  regularization_initial: float = 1e-6


def _shift(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
  """x padded with zero blocks along its first axis."""
  parts = []
  if before:
    parts.append(x.new_zeros((before,) + tuple(x.shape[1:])))
  parts.append(x)
  if after:
    parts.append(x.new_zeros((after,) + tuple(x.shape[1:])))
  return torch.cat(parts) if len(parts) > 1 else x


def chol_t_mult(ld, l1, l2, dq):
  """y = L^T dq for a block-banded lower factor L (ld diagonal, l1 and l2
  the blocks below); dq (T, nv)."""
  y = torch.einsum("tji,tj->ti", ld, dq)
  y = y + _shift(torch.einsum("tji,tj->ti", l1, dq[1:]), 0, 1)
  return y + _shift(torch.einsum("tji,tj->ti", l2, dq[2:]), 0, 2)


def chol_mult(ld, l1, l2, y):
  """x = L y for the same factor."""
  x = torch.einsum("tij,tj->ti", ld, y)
  x = x + _shift(torch.einsum("tij,tj->ti", l1, y[:-1]), 1, 0)
  return x + _shift(torch.einsum("tij,tj->ti", l2, y[:-2]), 2, 0)


def band_to_dense(pd, po1, po2) -> np.ndarray:
  """Block-band storage (diagonal, first and second off-diagonal blocks)
  -> the dense symmetric window matrix (host numpy)."""
  t_len, nv = pd.shape[0], pd.shape[1]
  n = t_len * nv
  h = np.zeros((n, n), pd.dtype)
  for i in range(t_len):
    h[i * nv:(i + 1) * nv, i * nv:(i + 1) * nv] = pd[i]
  for k, po in ((1, po1), (2, po2)):
    for i in range(t_len - k):
      h[i * nv:(i + 1) * nv, (i + k) * nv:(i + k + 1) * nv] = po[i]
      h[(i + k) * nv:(i + k + 1) * nv, i * nv:(i + 1) * nv] = po[i].T
  return h


class Direct:
  """Host wrapper around the Gauss-Newton solve, on `device` (default: the
  model's).

  Takes a Task (its `model`; the sensor function from the model's sensor
  table unless `sensor_fn` is given) or a Model and a `sensor_fn`.
  Optional model-parameter estimation: `param_update(Model, theta) ->
  Model` applies an nparam-vector (e.g. scaling dof damping); theta joins
  the decision variables and `optimize()` leaves it in `parameters`."""

  def __init__(self, task_or_model, horizon: int,
               sensor_fn: Optional[Callable] = None,
               settings: Optional[DirectSettings] = None,
               param_update: Optional[Callable] = None, nparam: int = 0,
               param_initial=None, banded: Optional[bool] = None,
               device=None):
    if hasattr(task_or_model, "model"):
      self.m = task_or_model.model
      d0 = task_or_model.make_data()
    else:
      if sensor_fn is None:
        raise ValueError("a bare Model needs its sensor_fn")
      self.m = task_or_model
      d0 = make_data(self.m)
    F.check_supported(self.m)
    self.sensor_fn = sensor_fn or sensors_lib.make_sensor_fn(self.m)
    self.device = torch.device(self.m.qpos0.device if device is None
                               else device)
    self._template = rollout_lib.from_carry(rollout_lib.slim_carry(d0))
    self.horizon = horizon
    self.settings = settings or DirectSettings()
    self.param_update = param_update
    self.nparam = nparam if param_update is not None else 0
    self.param_initial = (np.zeros(self.nparam) if param_initial is None
                          else np.asarray(param_initial))
    self.timestep = float(self.m.opt.timestep)     # read once, on the host
    dd = F.fwd_velocity(self.m, F.fwd_position(self.m, self._template))
    self.ns = int(self.sensor_fn(self.m, dd).shape[0])
    nv = self.m.nv
    self.nvar = horizon * nv + self.nparam

    # measured data (set on the host)
    self.sensor_measured = np.zeros((horizon, self.ns))
    self.force_measured = np.zeros((horizon, nv))
    self.qpos_initial = np.tile(d0.qpos.cpu().numpy(), (horizon, 1))
    self.weight_sensor = np.ones(self.ns)
    self.weight_force = np.ones(nv)
    self.prior_weight = 0.0   # set before the first optimize()
    self._prior_qpos = self.qpos_initial.copy()
    # optional matrix prior in block-band storage (Pd (T, nv, nv), Po1
    # (T-1, nv, nv), Po2 (T-2, nv, nv)), banded path only
    self.prior_band = None
    self._band_cache = None
    self.status = Status.UNSOLVED
    self.iterations = 0
    self.cost_history = []
    self.upload = HostUpload(self.device, slots=8)

    self.banded = (horizon >= 24) if banded is None else banded
    # the solve's start, iteration and close as functions of tensors, each
    # one graph on the card (the Batch estimator runs them in its update)
    start, iterate, close = (self._make_solve_banded() if self.banded
                             else self._make_solve())
    self._start, self._iterate, self._close_fn = (
        rollout_lib.GraphedFn(fn, self.device)
        for fn in (start, self._iteration(iterate), close))

  # -- residuals ---------------------------------------------------------------

  def _model(self, theta):
    return self.param_update(self.m, theta) if self.param_update else self.m

  def _stage(self, m, qt, vt, at, y_t, f_t, w_sensor, w_force):
    """Weighted sensor and force residuals of one stage."""
    d = self._template.replace(qpos=qt, qvel=vt)
    dd = F.fwd_velocity(m, F.fwd_position(m, d))
    y_pred = self.sensor_fn(m, dd)
    f_pred = inv_lib.force_at(dd, at)
    return torch.cat([torch.sqrt(w_sensor) * (y_pred - y_t),
                      torch.sqrt(w_force) * (f_pred - f_t)])

  def _residuals(self, qs, theta, sensor_meas, force_meas, w_sensor,
                 w_force, prior_qpos):
    """Stacked weighted residuals over the horizon: v_t = (q_t -
    q_{t-1})/h, a_t = (v_{t+1} - v_t)/h, sensor and force residuals at t =
    1..T-2, then the scalar prior's rows."""
    m = self._model(theta)
    h = self.timestep
    vs = deriv.qpos_diff(m, qs[1:], qs[:-1]) / h           # (T-1, nv)
    accs = (vs[1:] - vs[:-1]) / h                          # (T-2, nv)
    rs = vmap(lambda q, v, a, y, f: self._stage(
        m, q, v, a, y, f, w_sensor, w_force))(
            qs[1:-1], vs[:-1], accs, sensor_meas[1:-1], force_meas[1:-1])
    out = rs.reshape(-1)
    if self.prior_weight > 0.0:
      dq = deriv.qpos_diff(m, qs, prior_qpos)
      out = torch.cat([out, float(np.sqrt(self.prior_weight)) *
                       dq.reshape(-1)])
    return out

  def _iteration(self, step):
    """One Gauss-Newton iteration as a function of the flat (carry...,
    data...) tensors: the new carry, then [the loop's condition for the
    next iteration, the new cost, the initial cost] in one tensor (what
    the host reads)."""
    n = self._carry_len

    def iterate(*flat):
      new = step(flat[:n], flat[n:])
      cost, cost0 = new[-5], new[-4]
      flags = torch.stack([self._active(new).to(cost.dtype), cost, cost0])
      return tuple(new) + (flags,)

    return iterate

  def solve(self, *args):
    """The solve on the device from its tensor arguments: the start, then
    the iteration while the loop's condition holds (as `lax.while_loop`;
    the condition holds before the first), then the close. One read back an
    iteration: the condition and the cost (the initial cost and the cost
    after each iteration are left in `cost_history`). Returns (qs, theta,
    cost, cost0, iterations, status) on the device."""
    carry = self._start(*args)
    st = self.settings
    self.cost_history = []
    active = st.max_iterations > 0 and st.regularization_initial < 1e8
    while active:
      out = self._iterate(*carry, *args)
      carry, flags = out[:-1], out[-1]
      active, cost, cost0 = flags.tolist()
      self.cost_history += [cost] if self.cost_history else [cost0, cost]
    return self._close_fn(*carry, *args)

  def _line_search(self, cost_at, cost):
    """Backtracking: alpha = 1, 1/2, ... over ls_iterations; the best cost
    below `cost` and its alpha (0 if none)."""
    best_c, best_a = cost, torch.zeros_like(cost)
    alpha = 1.0
    for _ in range(self.settings.ls_iterations):
      c_try = cost_at(alpha)
      better = c_try < best_c
      best_c = torch.where(better, c_try, best_c)
      best_a = torch.where(better, torch.full_like(best_a, alpha), best_a)
      alpha *= 0.5
    return best_c, best_a

  def _update_rule(self, cost, new_cost, reg, grad):
    """(improved, the next regularisation, the status) after a step."""
    st = self.settings
    improved = new_cost < cost
    reg_new = torch.where(improved, torch.clamp(reg * 0.3, min=1e-10),
                          reg * 10.0)
    gnorm = torch.sqrt(torch.sum(grad * grad)) / self.nvar
    done = (gnorm < st.gradient_tolerance) | \
        (torch.abs(new_cost - cost) < st.cost_tolerance)
    status = torch.where(done, torch.full_like(reg, float(Status.SOLVED)),
                         torch.full_like(reg, float(Status.UNSOLVED)))
    return improved, reg_new, status

  # the carry of an iteration: (iterate..., cost, cost0, reg, it, status)
  def _active(self, carry):
    reg, it, status = carry[-3:]
    return (it < self.settings.max_iterations) & \
        (status == float(Status.UNSOLVED)) & (reg < 1e8)

  def _close(self, it, status):
    failed = (status == float(Status.UNSOLVED)) & \
        (it >= self.settings.max_iterations)
    return torch.where(failed, torch.full_like(
        status, float(Status.MAX_ITERATIONS_FAILURE)), status)

  def _scalars(self, like):
    st = self.settings
    return (torch.full((), st.regularization_initial, dtype=like.dtype,
                       device=like.device),
            torch.zeros((), dtype=like.dtype, device=like.device),
            torch.full((), float(Status.UNSOLVED), dtype=like.dtype,
                       device=like.device))

  # -- dense solve -------------------------------------------------------------

  def _make_solve(self):
    """(start, iterate, close) of the dense solve; the iterate is the
    tangent step dz over all configurations (and the parameters)."""
    m0 = self.m
    nv, t_hor = m0.nv, self.horizon
    qpos_add = vmap(lambda q, dq: deriv.qpos_add(m0, q, dq))
    self._carry_len = 6

    def resid(dz, q_init, theta0, sensor_meas, force_meas, w_sensor,
              w_force, prior_qpos):
      qs = qpos_add(q_init, dz[:t_hor * nv].reshape(t_hor, nv))
      return self._residuals(qs, theta0 + dz[t_hor * nv:], sensor_meas,
                             force_meas, w_sensor, w_force, prior_qpos)

    def cost_of(dz, *data):
      r = resid(dz, *data)
      return 0.5 * torch.sum(r * r)

    def start(*data):
      dz0 = torch.zeros(self.nvar, dtype=data[0].dtype,
                        device=data[0].device)
      cost0 = cost_of(dz0, *data)
      return (dz0, cost0, cost0) + self._scalars(cost0)

    def iterate(carry, data):
      dz, cost, cost0, reg, it, status = carry
      r = resid(dz, *data)
      jac = jacrev(resid)(dz, *data).to(dz.dtype)
      grad = jac.transpose(0, 1) @ r
      hess = jac.transpose(0, 1) @ jac + reg * torch.eye(
          self.nvar, dtype=dz.dtype, device=dz.device)
      chol = torch.linalg.cholesky_ex(hess).L
      p = -cho_solve(chol, grad[:, None])[:, 0]
      new_cost, alpha = self._line_search(
          lambda a: cost_of(dz + a * p, *data), cost)
      improved, reg_new, status_new = self._update_rule(cost, new_cost, reg,
                                                        grad)
      return (torch.where(improved, dz + alpha * p, dz),
              torch.where(improved, new_cost, cost), cost0, reg_new, it + 1,
              status_new)

    def close(dz, cost, cost0, reg, it, status, q_init, theta0, *data):
      qs = qpos_add(q_init, dz[:t_hor * nv].reshape(t_hor, nv))
      return (qs, theta0 + dz[t_hor * nv:], cost, cost0, it,
              self._close(it, status))

    return start, iterate, close


  # -- banded solve ------------------------------------------------------------

  def _make_solve_banded(self):
    """Gauss-Newton with per-stage Jacobian blocks and the square-root
    banded solve; the iterate is the configuration sequence itself (each
    step retracted on the manifold)."""
    m0 = self.m
    nv, t_hor, nparam = m0.nv, self.horizon, self.nparam
    h = self.timestep
    qpos_add = vmap(lambda q, dq: deriv.qpos_add(m0, q, dq))

    def stage_res(q3, theta, y_t, f_t, w_sensor, w_force):
      """The residual of one interior stage from (q_{t-1}, q_t, q_{t+1})."""
      m = self._model(theta)
      v1 = deriv.qpos_diff(m, q3[1], q3[0]) / h
      v2 = deriv.qpos_diff(m, q3[2], q3[1]) / h
      return self._stage(m, q3[1], v1, (v2 - v1) / h, y_t, f_t, w_sensor,
                         w_force)

    def stage_res_tangent(dz3, dth, q3, theta, y_t, f_t, ws, wf):
      q3n = qpos_add(q3, dz3.reshape(3, nv))
      return stage_res(q3n, theta + dth, y_t, f_t, ws, wf)

    def prior_res(dq, q_t, q_prior):
      return float(np.sqrt(self.prior_weight)) * deriv.qpos_diff(
          m0, deriv.qpos_add(m0, q_t, dq), q_prior)

    def stages(qs):
      return torch.stack([qs[:-2], qs[1:-1], qs[2:]], dim=1)

    def cost_of(qs, theta, sensor_meas, force_meas, w_sensor, w_force,
                prior_qpos, ld, l1, l2):
      rs = vmap(lambda q3, y, f: stage_res(q3, theta, y, f, w_sensor,
                                           w_force))(
          stages(qs), sensor_meas[1:-1], force_meas[1:-1])
      c = 0.5 * torch.sum(rs * rs)
      dq = deriv.qpos_diff(m0, qs, prior_qpos)
      if self.prior_weight > 0.0:
        c = c + 0.5 * self.prior_weight * torch.sum(dq * dq)
      yp = chol_t_mult(ld, l1, l2, dq)
      return c + 0.5 * torch.sum(yp * yp)

    def assemble(qs, theta, sensor_meas, force_meas, w_sensor, w_force,
                 prior_qpos, ld, l1, l2):
      """Band storage (d1, o1, o2), gradient g, the parameter border, the
      raw per-stage Jacobian blocks, and the prior's square-root rows, at
      (qs, theta), without regularisation (the band is the information
      matrix the Batch estimator conditions). The matrix prior comes as
      its block-banded Cholesky factor (ld, l1, l2), P = L L^T."""
      dtype, dev = qs.dtype, qs.device
      zeros3 = torch.zeros(3 * nv, dtype=dtype, device=dev)
      zth = torch.zeros(nparam, dtype=dtype, device=dev)

      def per_stage(q3, y_t, f_t):
        args = (q3, theta, y_t, f_t, w_sensor, w_force)
        r = stage_res_tangent(zeros3, zth, *args)
        if nparam:
          j3, jth = jacrev(stage_res_tangent, argnums=(0, 1))(zeros3, zth,
                                                           *args)
        else:
          j3 = jacrev(stage_res_tangent)(zeros3, zth, *args)
          jth = torch.zeros((r.shape[0], 0), dtype=dtype, device=dev)
        return r, j3.to(dtype), jth.to(dtype)

      rs, j3s, jths = vmap(per_stage)(stages(qs), sensor_meas[1:-1],
                                      force_meas[1:-1])
      a_b, b_b, c_b = j3s[..., :nv], j3s[..., nv:2 * nv], j3s[..., 2 * nv:]

      def acc(x, y):
        return torch.einsum("tri,trj->tij", x, y)

      d1 = _shift(acc(a_b, a_b), 0, 2) + _shift(acc(b_b, b_b), 1, 1) + \
          _shift(acc(c_b, c_b), 2, 0)
      o1 = _shift(acc(a_b, b_b), 0, 1) + _shift(acc(b_b, c_b), 1, 0)
      o2 = acc(a_b, c_b)

      def grad_of(x):
        return torch.einsum("tri,tr->ti", x, rs)

      g = _shift(grad_of(a_b), 0, 2) + _shift(grad_of(b_b), 1, 1) + \
          _shift(grad_of(c_b), 2, 0)

      dq_p = deriv.qpos_diff(m0, qs, prior_qpos)
      rp_rows = chol_t_mult(ld, l1, l2, dq_p)
      ld_eff = ld
      if self.prior_weight > 0.0:
        zero_dq = torch.zeros(nv, dtype=dtype, device=dev)
        rps = vmap(lambda q, qp: prior_res(zero_dq, q, qp))(qs, prior_qpos)
        jps = vmap(lambda q, qp: jacrev(prior_res)(zero_dq, q, qp))(
            qs, prior_qpos).to(dtype)
        ld_eff = ld + jps.transpose(1, 2)
        rp_rows = rps + rp_rows

      # H += P = L L^T, g += P dq
      g = g + chol_mult(ld, l1, l2, chol_t_mult(ld, l1, l2, dq_p))
      d1 = d1 + torch.einsum("tik,tjk->tij", ld, ld) + \
          _shift(torch.einsum("tik,tjk->tij", l1, l1), 1, 0) + \
          _shift(torch.einsum("tik,tjk->tij", l2, l2), 2, 0)
      o1 = o1 + torch.einsum("tik,tjk->tij", ld[:-1], l1) + \
          _shift(torch.einsum("tik,tjk->tij", l1[:-1], l2), 1, 0)
      o2 = o2 + torch.einsum("tik,tjk->tij", ld[:-2], l2)
      if self.prior_weight > 0.0:
        d1 = d1 + torch.einsum("tri,trj->tij", jps, jps)
        g = g + torch.einsum("tri,tr->ti", jps, rps)

      if nparam:
        p_b = _shift(torch.einsum("tri,trp->tip", a_b, jths), 0, 2) + \
            _shift(torch.einsum("tri,trp->tip", b_b, jths), 1, 1) + \
            _shift(torch.einsum("tri,trp->tip", c_b, jths), 2, 0)
        q_blk = torch.einsum("trp,trq->pq", jths, jths)
        g_th = torch.einsum("trp,tr->p", jths, rs)
      else:
        p_b = q_blk = g_th = None
      return (d1, o1, o2, g, p_b, q_blk, g_th, a_b, b_b, c_b, rs, jths,
              ld_eff, rp_rows)

    self._assemble_banded = assemble

    self._carry_len = 7

    def start(q_init, theta0, *data):
      cost0 = cost_of(q_init, theta0, *data)
      return (q_init, theta0, cost0, cost0) + self._scalars(cost0)

    def iterate(carry, args):
      qs, theta, cost, cost0, reg, it, status = carry
      data = args[2:]                 # (sensor_meas, ..., ld, l1, l2)
      l1, l2 = data[-2:]
      (_, _, _, g, _, _, _, a_b, b_b, c_b, rs, jths, ld_eff,
       rp_rows) = assemble(qs, theta, *data)
      dz, dth = band_lib.srif_gn_solve(a_b, b_b, c_b, rs, ld_eff, l1, l2,
                                       rp_rows, reg,
                                       Jth=jths if nparam else None)

      def retract(alpha):
        qn = qpos_add(qs, alpha * dz)
        return qn, (theta + alpha * dth) if nparam else theta

      new_cost, alpha = self._line_search(
          lambda a: cost_of(*retract(a), *data), cost)
      improved, reg_new, status_new = self._update_rule(cost, new_cost, reg,
                                                        g)
      qs_new, th_new = retract(alpha)
      return (torch.where(improved, qs_new, qs),
              th_new if nparam else theta,
              torch.where(improved, new_cost, cost), cost0, reg_new, it + 1,
              status_new)

    def close(qs, theta, cost, cost0, reg, it, status, *args):
      return qs, theta, cost, cost0, it, self._close(it, status)

    return start, iterate, close

  # -- public API (reference Direct::Optimize and the data setters) ----------

  def set_data(self, t: int, qpos=None, sensor=None, force=None):
    if qpos is not None:
      self.qpos_initial[t] = np.asarray(qpos)
    if sensor is not None:
      self.sensor_measured[t] = np.asarray(sensor)
    if force is not None:
      self.force_measured[t] = np.asarray(force)

  def set_weights(self, sensor=None, force=None):
    if sensor is not None:
      self.weight_sensor = np.asarray(sensor) * np.ones(self.ns)
    if force is not None:
      self.weight_force = np.asarray(force) * np.ones(self.m.nv)

  def _args(self, qs=None, theta=None):
    """The solve's tensor arguments from the host-side data."""
    up = self.upload
    return (up(self.qpos_initial if qs is None else qs),
            up(self.param_initial if theta is None else theta),
            up(self.sensor_measured), up(self.force_measured),
            up(self.weight_sensor), up(self.weight_force),
            up(self._prior_qpos))

  def hessian_band(self, qs=None, theta=None):
    """The Gauss-Newton information matrix (no regularisation) in
    block-band storage (d1, o1, o2), at the given (default: the last
    optimised) configurations, prior terms included (the Batch estimator's
    recursive prior update, reference batch.cc:354-384)."""
    if not self.banded:
      raise ValueError("hessian_band needs the banded path")
    qs = self.qpos_optimized if qs is None else qs
    theta = self.parameters if theta is None else theta
    out = self._assemble_banded(*self._args(qs, theta), *self._band_args())
    return tuple(x.cpu().numpy() for x in out[:3])

  def _band_args(self):
    """The block-banded lower Cholesky factor (ld, l1, l2) of the matrix
    prior, on the device; computed on the host in float64 (the prior
    accumulates conditioned Hessians whose entries span ~1e8) when the
    prior changes, zeros without one."""
    nv, t_hor = self.m.nv, self.horizon
    if self.prior_band is None:
      z = torch.zeros((t_hor, nv, nv), dtype=torch.float32,
                      device=self.device)
      return z, z[:-1], z[:-2]
    if self._band_cache is not None and \
        self._band_cache[0] is self.prior_band:
      return self._band_cache[1]
    if self.prior_weight != 0.0:
      raise ValueError("scalar and matrix priors are mutually exclusive")
    w = band_to_dense(*[np.asarray(x, np.float64) for x in self.prior_band])
    n = t_hor * nv
    jit_eps = max(1e-12, 1e-9 * float(np.abs(np.diag(w)).max()))
    lfull = np.linalg.cholesky(w + jit_eps * np.eye(n))

    def blocks(k):
      return np.stack([lfull[(i + k) * nv:(i + k + 1) * nv,
                             i * nv:(i + 1) * nv]
                       for i in range(t_hor - k)])

    out = tuple(self.upload(blocks(k)).clone() for k in range(3))
    self._band_cache = (self.prior_band, out)
    return out

  def optimize(self):
    args = self._args()
    if self.banded:
      args = args + self._band_args()
    elif self.prior_band is not None:
      raise ValueError("a matrix prior (prior_band) needs the banded path")
    qs, theta, cost, cost0, it, status = self.solve(*args)
    # the outputs in one read back
    flat = torch.cat([qs.reshape(-1), theta.reshape(-1),
                      torch.stack([cost, cost0, it, status])]).cpu().numpy()
    nq = self.m.nq
    n = self.horizon * nq
    self.qpos_optimized = flat[:n].reshape(self.horizon, nq)
    self.parameters = flat[n:n + self.nparam]
    self.cost, self.cost_initial = float(flat[-4]), float(flat[-3])
    self.iterations = int(flat[-2])
    status = int(flat[-1])
    self.status = Status(status) if status != 0 else \
        Status.MAX_ITERATIONS_FAILURE
    return self.qpos_optimized
