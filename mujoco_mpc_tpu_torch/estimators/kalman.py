"""Extended Kalman filter.

Reference semantics (mjpc/estimators/kalman.{h,cc}), as the JAX package's
estimators/kalman.py:
  * measurement update: the sensor Jacobian C by AD in the
    quaternion-aware tangent space, the gain through
    a Cholesky factor of C P C' + R, the correction applied on the tangent
    (derivatives.state_add), P <- (I - K C) P;
  * prediction update: step the model, A = d step / dx by AD,
    P <- A P A' + Q;
  * diagonal process and sensor noise, settable (`set_noise`).

Both Jacobians come from `torch.func.jacrev` (reverse mode), where the JAX
package uses forward mode: the same matrices to rounding (6e-8 on
Cartpole's A), at a third of the host time of `torch.func.jacfwd` on the
CPU, whose forward-mode rules go through zero-tensor decompositions there.

The measurement, the prediction, the fused update (measurement, then
prediction) and the agent's step (prediction, then measurement: `step`)
are each a pure function of tensors; on a CUDA device each runs as one
CUDA graph (`rollout.GraphedFn`, captured at its first call, so a caller
that only steps captures one), the counterpart of the JAX package's
`jax.jit` of each. The pipeline
physics inside takes the library Cholesky route (differentiable).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import jacrev

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.estimators import base
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import sensors as sensors_lib
from mujoco_mpc_tpu_torch.planners import derivatives as deriv


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """(L L') x = rhs for a lower Cholesky factor L and a matrix rhs, by two
  triangular solves."""
  y = torch.linalg.solve_triangular(chol, rhs, upper=False)
  return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


def sensor_at(m, template, sensor_fn, state, ctrl):
  """The sensor reading at a packed state under `ctrl`: after a full
  forward pass where a sensor reads the acceleration stage, else after
  the position, velocity and actuation stages (the same reading without
  the constraint solve)."""
  d = rollout_lib.set_state(m, template, state).replace(ctrl=ctrl)
  if getattr(sensor_fn, "needs_acc", True):
    return sensor_fn(m, F.forward(m, d))
  d = F.fwd_actuation(m, F.fwd_velocity(m, F.fwd_position(m, d)))
  return sensor_fn(m, d)


class Kalman(base.Estimator):
  """EKF (reference GUI name: "Kalman") on `device` (default: the
  task's)."""

  def __init__(self, task, sensor_fn=None, device=None):
    self.task = task
    self.m = task.model
    self.device = torch.device(task.device if device is None else device)
    F.check_supported(self.m)
    self.timestep = float(self.m.opt.timestep)     # read once, on the host
    self.nx = deriv.ndx(self.m)
    self.sensor_fn = sensor_fn or sensors_lib.make_sensor_fn(self.m)
    self._template = rollout_lib.from_carry(
        rollout_lib.slim_carry(task.make_data()))
    self.ns = int(sensor_at(self.m, self._template, self.sensor_fn,
                            rollout_lib.pack_state(self._template),
                            self._template.ctrl).shape[0])
    self.upload = base.HostUpload(self.device)
    self._measure = rollout_lib.GraphedFn(self._measure_impl, self.device)
    self._predict = rollout_lib.GraphedFn(self._predict_impl, self.device)
    self._update = rollout_lib.GraphedFn(self._update_impl, self.device)
    self._step = rollout_lib.GraphedFn(self._step_impl, self.device)
    self.reset()

  def _eye(self, n):
    return torch.eye(n, dtype=torch.float32, device=self.device)

  def reset(self):
    self.x = rollout_lib.pack_state(self.task.make_data()).clone()
    self.p = 1e-4 * self._eye(self.nx)
    self.q_noise = 1e-4 * torch.ones(self.nx, device=self.device)
    self.r_noise = 1e-3 * torch.ones(self.ns, device=self.device)
    self.time = 0.0

  # -- the update functions (pure functions of tensors) ----------------------

  def _measure_impl(self, x, p, r_noise, ctrl, y):
    m = self.m

    def h(dx):
      return sensor_at(m, self._template, self.sensor_fn,
                       deriv.state_add(m, x, dx), ctrl)

    zero = torch.zeros(self.nx, dtype=x.dtype, device=x.device)
    y_pred = h(zero)
    c = jacrev(h)(zero).to(x.dtype)                       # (ns, nx)
    s = c @ p @ c.transpose(0, 1) + torch.diag(r_noise)
    chol = torch.linalg.cholesky_ex(s + 1e-9 * self._eye(self.ns)).L
    k = cho_solve(chol, c @ p).transpose(0, 1)            # (nx, ns)
    innov = y - y_pred
    x_new = deriv.state_add(m, x, k @ innov)
    p_new = (self._eye(self.nx) - k @ c) @ p
    return x_new, 0.5 * (p_new + p_new.transpose(0, 1)), innov

  def _predict_impl(self, x, p, q_noise, ctrl):
    m = self.m
    step_fn = deriv.make_step_fn(m, self._template)
    t0 = torch.zeros((), dtype=x.dtype, device=x.device)
    x_next = step_fn(x, ctrl, t0)

    def f(dx):
      return deriv.state_diff(m, step_fn(deriv.state_add(m, x, dx), ctrl,
                                         t0), x_next)

    a = jacrev(f)(torch.zeros(self.nx, dtype=x.dtype,
                              device=x.device)).to(x.dtype)
    p_new = a @ p @ a.transpose(0, 1) + torch.diag(q_noise)
    return x_next, 0.5 * (p_new + p_new.transpose(0, 1))

  def _update_impl(self, x, p, q_noise, r_noise, ctrl, y):
    x1, p1, innov = self._measure_impl(x, p, r_noise, ctrl, y)
    x2, p2 = self._predict_impl(x1, p1, q_noise, ctrl)
    return x2, p2, innov

  def _step_impl(self, x, p, q_noise, r_noise, ctrl, y):
    x1, p1 = self._predict_impl(x, p, q_noise, ctrl)
    return self._measure_impl(x1, p1, r_noise, ctrl, y)

  # -- public API (reference kalman.h split update) --------------------------

  def update_measurement(self, ctrl, sensor):
    self.x, self.p, innov = self._measure(
        self.x, self.p, self.r_noise, self.upload(ctrl), self.upload(sensor))
    return innov

  def update_prediction(self, ctrl):
    self.x, self.p = self._predict(self.x, self.p, self.q_noise,
                                   self.upload(ctrl))

  def update(self, ctrl, sensor):
    """One EKF step (measurement, then prediction); returns the state on
    the device (`state` is its host copy)."""
    self.x, self.p, _ = self._update(self.x, self.p, self.q_noise,
                                     self.r_noise, self.upload(ctrl),
                                     self.upload(sensor))
    self.time += self.timestep
    return self.x

  def step(self, ctrl, sensor):
    """The agent's step: predict under `ctrl` (t -> t+1), then correct with
    the reading taken after the step, as one function (one CUDA graph on
    the card); the same as update_prediction then update_measurement."""
    self.x, self.p, innov = self._step(
        self.x, self.p, self.q_noise, self.r_noise, self.upload(ctrl),
        self.upload(sensor))
    self.time += self.timestep
    return innov

  @property
  def state_tensor(self):
    return self.x

  @property
  def state(self):
    return self.x.cpu().numpy()

  @property
  def covariance(self):
    return self.p.cpu().numpy()

  def set_state(self, state):
    self.x = self.upload(state).clone()

  def set_noise(self, process: Optional[np.ndarray] = None,
                sensor: Optional[np.ndarray] = None):
    if process is not None:
      self.q_noise = self.upload(process).clone()
    if sensor is not None:
      self.r_noise = self.upload(sensor).clone()
