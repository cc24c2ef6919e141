"""Unscented Kalman filter.

Reference semantics (mjpc/estimators/unscented.{h,cc}), as the JAX
package's estimators/unscented.py: 2*ndx+1 sigma points on the
quaternion-aware tangent, the alpha/beta/lambda weights of
unscented.cc:134-143, and one joint update of state and sensor
covariances (prediction and measurement together).

All sigma points go through one `torch.func.vmap` of the pipeline step and
the sensor evaluation on the kernel solve route (`Model.solve_route =
"kernel"`, as `rollout.make_batched_returns` sets it): on a CUDA device
each SPD solve of that batch is one launch of the batched Cholesky kernel
(ops/cholesky.py, kernel B4) over the 2*ndx+1 points. The update is a pure
function of tensors and runs as one CUDA graph on the card
(`rollout.GraphedFn`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.estimators import base
from mujoco_mpc_tpu_torch.estimators.kalman import cho_solve, sensor_at
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.physics import sensors as sensors_lib
from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.planners import derivatives as deriv


class Unscented(base.Estimator):
  """UKF (reference GUI name: "Unscented") on `device` (default: the
  task's)."""

  def __init__(self, task, sensor_fn=None, alpha=1.0, beta=2.0,
               device=None):
    self.task = task
    self.m = task.model
    self.device = torch.device(task.device if device is None else device)
    F.check_supported(self.m)
    self.timestep = float(self.m.opt.timestep)     # read once, on the host
    self.mk = self.m.replace(solve_route=S.SOLVE_KERNEL)
    self.nx = deriv.ndx(self.m)
    self.alpha, self.beta = alpha, beta
    self.sensor_fn = sensor_fn or sensors_lib.make_sensor_fn(self.m)
    self._template = rollout_lib.from_carry(
        rollout_lib.slim_carry(task.make_data()))
    self.ns = int(sensor_at(self.m, self._template, self.sensor_fn,
                            rollout_lib.pack_state(self._template),
                            self._template.ctrl).shape[0])
    self.upload = base.HostUpload(self.device)
    self.wm, self.wc, self.c = self.weights()
    self._update = rollout_lib.GraphedFn(self._update_impl, self.device)
    self.reset()

  def _eye(self, n):
    return torch.eye(n, dtype=torch.float32, device=self.device)

  def reset(self):
    self.x = rollout_lib.pack_state(self.task.make_data()).clone()
    self.p = 1e-4 * self._eye(self.nx)
    self.q_noise = 1e-4 * torch.ones(self.nx, device=self.device)
    self.r_noise = 1e-3 * torch.ones(self.ns, device=self.device)
    self.time = 0.0

  def weights(self):
    """(wm, wc, c) of the 2*ndx+1 sigma points (unscented.cc:134-143,
    kappa = 0), made once on the host."""
    nx = self.nx
    lam = self.alpha ** 2 * nx - nx
    c = nx + lam
    wm = np.full((2 * nx + 1,), 1.0 / (2 * c), np.float32)
    wc = wm.copy()
    wm[0] = lam / c
    wc[0] = lam / c + (1 - self.alpha ** 2 + self.beta)
    return (torch.as_tensor(wm).to(self.device),
            torch.as_tensor(wc).to(self.device), c)

  def _update_impl(self, x, p, q_noise, r_noise, ctrl, y):
    nx, ns = self.nx, self.ns
    mk = self.mk
    wm, wc, c = self.wm, self.wc, self.c

    # sigma points on the tangent
    chol = torch.linalg.cholesky_ex(c * (p + 1e-9 * self._eye(nx))).L
    deltas = torch.cat([torch.zeros((1, nx), dtype=x.dtype, device=x.device),
                        chol.transpose(0, 1), -chol.transpose(0, 1)], dim=0)
    sigma = vmap(lambda dx: deriv.state_add(mk, x, dx))(deltas)

    # dynamics and sensors of every sigma point: one vmapped batch
    step_fn = deriv.make_step_fn(mk, self._template)
    t0 = torch.zeros((), dtype=x.dtype, device=x.device)

    def prop(s):
      nxt = step_fn(s, ctrl, t0)
      return nxt, sensor_at(mk, self._template, self.sensor_fn, nxt, ctrl)

    nxts, ys = vmap(prop)(sigma)

    # means (the tangent mean around the propagated centre point)
    center = nxts[0]
    dxs = deriv.state_diff(mk, nxts, center[None])
    dx_mean = wm @ dxs
    x_mean = deriv.state_add(mk, center, dx_mean)
    y_mean = wm @ ys

    # covariances
    dxs_c = dxs - dx_mean[None]
    dys = ys - y_mean[None]
    pxx = (dxs_c * wc[:, None]).transpose(0, 1) @ dxs_c + torch.diag(q_noise)
    pyy = (dys * wc[:, None]).transpose(0, 1) @ dys + torch.diag(r_noise)
    pxy = (dxs_c * wc[:, None]).transpose(0, 1) @ dys

    # gain and correction
    chol_y = torch.linalg.cholesky_ex(pyy + 1e-9 * self._eye(ns)).L
    k = cho_solve(chol_y, pxy.transpose(0, 1)).transpose(0, 1)   # (nx, ns)
    innov = y - y_mean
    x_new = deriv.state_add(mk, x_mean, k @ innov)
    p_new = pxx - k @ pyy @ k.transpose(0, 1)
    return x_new, 0.5 * (p_new + p_new.transpose(0, 1)), innov

  def update(self, ctrl, sensor):
    """One UKF step; returns the state on the device (`state` is its host
    copy)."""
    self.x, self.p, _ = self._update(self.x, self.p, self.q_noise,
                                     self.r_noise, self.upload(ctrl),
                                     self.upload(sensor))
    self.time += self.timestep
    return self.x

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

  def set_noise(self, process=None, sensor=None):
    if process is not None:
      self.q_noise = self.upload(process).clone()
    if sensor is not None:
      self.r_noise = self.upload(sensor).clone()
