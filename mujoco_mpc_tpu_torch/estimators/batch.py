"""Batch estimator: a recursive fixed-lag smoother on the Direct optimizer,
as the JAX package's estimators/batch.py (reference
mjpc/estimators/batch.{h,cc}).

A sliding window of the last `configuration_length` configurations is
re-optimised at every update against the buffered (ctrl, sensor) history,
with a Gaussian prior on the window; the window then shifts forward
(history at most MAX_FILTER_HISTORY = 64, batch.h:35). The prior is a
matrix weight P on the window tangent in block-band storage, initially
scale_prior * I. With the recursive prior update the Gauss-Newton
information matrix after each optimisation is conditioned on dropping the
oldest configuration (a Schur complement, host numpy) and becomes the
shifted window's prior (batch.cc:352-384).

One update predicts the newest configuration and shifts the window (one
pure function of tensors), re-optimises on the banded Direct solve (its
start, its iterations while the loop's condition holds, its close), and
finite-differences the velocity (one more function): on the card each is
one CUDA graph (`rollout.GraphedFn`). Its inputs go up through pinned
buffers; the Direct loop reads its condition back once an iteration, and
the update's outputs come back in one read.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.direct.optimizer import (Direct, DirectSettings,
                                                   Status, band_to_dense)
from mujoco_mpc_tpu_torch.estimators import base
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.planners import derivatives as deriv

MAX_FILTER_HISTORY = 64  # reference batch.h:35


def dense_to_band(h, t_len, nv):
  """Band-limit a dense window matrix to 3 nv-blocks (reference
  DenseToBlockBand(..., nv, 3)); symmetrises the diagonal blocks."""
  pd = np.stack([h[i * nv:(i + 1) * nv, i * nv:(i + 1) * nv]
                 for i in range(t_len)])
  pd = 0.5 * (pd + np.transpose(pd, (0, 2, 1)))

  def off(k):
    if t_len <= k:
      return np.zeros((0, nv, nv), h.dtype)
    return np.stack([h[i * nv:(i + 1) * nv, (i + k) * nv:(i + k + 1) * nv]
                     for i in range(t_len - k)])

  return pd, off(1), off(2)


class Batch(base.Estimator):
  """Fixed-lag batch smoother (reference GUI name: "Batch") on `device`
  (default: the task's)."""

  def __init__(self, task, configuration_length: Optional[int] = None,
               recursive_prior_update: bool = False, device=None):
    self.task = task
    self.m = task.model
    self.device = torch.device(task.device if device is None else device)
    cfg_len = configuration_length or int(
        task.config("batch_configuration_length", 3))
    self.cfg_len = min(max(cfg_len, 3), MAX_FILTER_HISTORY)
    self.prior_scale = float(task.config("batch_scale_prior", 1e-3))
    self.recursive_prior_update = recursive_prior_update
    self.timestep = float(self.m.opt.timestep)     # read once, on the host
    self._template = rollout_lib.from_carry(
        rollout_lib.slim_carry(task.make_data()))
    self.upload = base.HostUpload(self.device, slots=16)
    self._make_direct()
    self.reset()

  def _make_direct(self):
    self.direct = Direct(
        self.task, self.cfg_len, banded=True, device=self.device,
        settings=DirectSettings(max_iterations=6, ls_iterations=6))
    # the update pins the parameters to param_initial: a Direct that
    # estimates parameters would be silently disabled, so refuse it
    if self.direct.nparam != 0:
      raise ValueError(
          "Batch filtering does not support joint parameter estimation; "
          "run a standalone Direct optimizer with param_update instead")
    self.direct.set_weights(sensor=1e3, force=1.0)
    self.sensor_fn = self.direct.sensor_fn
    self._shift = rollout_lib.GraphedFn(self._shift_impl, self.device)
    self._finish = rollout_lib.GraphedFn(self._finish_impl, self.device)

  def _shift_impl(self, q_hist, qvel, ctrl, sensor, sensor_hist,
                  force_hist):
    """Predict the newest configuration and its actuator force, and shift
    the windows (batch.cc Update, before the optimisation)."""
    m, h = self.m, self.timestep
    q_pred = deriv.qpos_add(m, q_hist[-1], qvel * h)
    d = F.forward(m, self._template.replace(qpos=q_pred, qvel=qvel,
                                            ctrl=ctrl))
    return (torch.cat([q_hist[1:], q_pred[None]]),
            torch.cat([sensor_hist[1:], sensor[None]]),
            torch.cat([force_hist[1:], d.qfrc_actuator[None]]))

  def _finish_impl(self, qs, s_win, f_win, cost, it, status):
    """The velocity from the optimised window's last two configurations,
    and the update's outputs flattened for one read back."""
    qvel_new = deriv.qpos_diff(self.m, qs[-1], qs[-2]) / self.timestep
    return torch.cat([qs.reshape(-1), s_win.reshape(-1), f_win.reshape(-1),
                      qvel_new, torch.stack([cost, it, status])])

  def _prior_identity(self):
    nv, t_len = self.m.nv, self.cfg_len
    pd = np.tile(self.prior_scale * np.eye(nv, dtype=np.float32),
                 (t_len, 1, 1))
    return (pd, np.zeros((t_len - 1, nv, nv), np.float32),
            np.zeros((t_len - 2, nv, nv), np.float32))

  def reset(self):
    q0 = self.task.make_data().qpos.cpu().numpy()
    n = self.cfg_len
    self.q_history = deque([q0.copy() for _ in range(n)], maxlen=n)
    self.sensor_history = deque([np.zeros(self.direct.ns) for _ in range(n)],
                                maxlen=n)
    self.force_history = deque([np.zeros(self.m.nv) for _ in range(n)],
                               maxlen=n)
    self.qvel_est = np.zeros(self.m.nv)
    self.time = 0.0
    # the prior weight matrix: scale_prior * I (batch.cc:796)
    self.direct.prior_band = self._prior_identity()
    self.direct.prior_weight = 0.0

  def shift_resize(self, new_length: int):
    """Resize the window at run time, keeping the newest history
    (reference Batch::ShiftResizeTrajectory, batch.cc:801)."""
    new_length = min(max(new_length, 3), MAX_FILTER_HISTORY)
    if new_length == self.cfg_len:
      return
    old = (list(self.q_history), list(self.sensor_history),
           list(self.force_history))
    old_prior = self.direct.prior_band
    old_len = self.cfg_len
    self.cfg_len = new_length
    self._make_direct()

    def refit(items):
      if new_length <= old_len:
        kept = items[old_len - new_length:]
      else:
        kept = [items[0].copy() for _ in range(new_length - old_len)] + \
            list(items)
      return deque(kept, maxlen=new_length)

    self.q_history, self.sensor_history, self.force_history = (
        refit(x) for x in old)
    # the prior keeps the newest blocks' weights; new (older) slots get
    # scale_prior * I
    pd, po1, po2 = self._prior_identity()
    if old_prior is not None:
      keep = min(old_len, new_length)
      pd[-keep:] = old_prior[0][-keep:]
      if keep > 1:
        po1[-(keep - 1):] = old_prior[1][-(keep - 1):]
      if keep > 2:
        po2[-(keep - 2):] = old_prior[2][-(keep - 2):]
    self.direct.prior_band = (pd, po1, po2)

  def _prior_update(self):
    """Recursive prior update: condition the window's information matrix
    on dropping the oldest configuration (batch.cc:352-384)."""
    nv, t_len = self.m.nv, self.cfg_len
    h = band_to_dense(*self.direct.hessian_band())
    # the Schur complement removing the first nv dims (ConditionMatrix)
    h00 = h[:nv, :nv] + 1e-8 * np.eye(nv)
    h10 = h[nv:, :nv]
    cond = h[nv:, nv:] - h10 @ np.linalg.solve(h00, h10.T)
    # the shifted window: the conditioned marginal for slots 0..T-2, a
    # fresh scale_prior * I for the incoming configuration
    n = t_len * nv
    w = np.zeros((n, n), np.float32)
    w[:n - nv, :n - nv] = cond
    w[n - nv:, n - nv:] = self.prior_scale * np.eye(nv)
    self.direct.prior_band = dense_to_band(w, t_len, nv)

  def update(self, ctrl, sensor):
    """Shift the window, append the measurement, re-optimise (batch.cc
    Update) on the device; the outputs in one read back."""
    dr = self.direct
    up = self.upload
    q_win, s_win, f_win = self._shift(
        up(np.array(self.q_history)), up(self.qvel_est), up(ctrl),
        up(sensor), up(np.array(self.sensor_history)),
        up(np.array(self.force_history)))
    qs, _, cost, _, it, status = dr.solve(
        q_win, up(dr.param_initial), s_win, f_win, up(dr.weight_sensor),
        up(dr.weight_force), q_win, *dr._band_args())
    flat = self._finish(qs, s_win, f_win, cost, it, status)
    flat = flat.cpu().numpy().astype(np.float64)
    n, nq, nv, ns = self.cfg_len, self.m.nq, self.m.nv, dr.ns
    qs = flat[:n * nq].reshape(n, nq)
    k = n * nq
    s_win = flat[k:k + n * ns].reshape(n, ns)
    k += n * ns
    f_win = flat[k:k + n * nv].reshape(n, nv)
    k += n * nv
    self.qvel_est = flat[k:k + nv].copy()
    cost, it, status = flat[-3:]

    # mirror the optimised window into the host history and the Direct's
    # bookkeeping (hessian_band reads these)
    for t in range(n):
      self.q_history[t] = qs[t].copy()
      self.sensor_history[t] = s_win[t].copy()
      self.force_history[t] = f_win[t].copy()
    dr.qpos_initial = np.array(self.q_history)
    dr.sensor_measured = np.array(self.sensor_history)
    dr.force_measured = np.array(self.force_history)
    dr._prior_qpos = np.array(self.q_history)
    dr.qpos_optimized = qs.copy()
    dr.parameters = np.asarray(dr.param_initial)
    dr.cost = float(cost)
    dr.iterations = int(it)
    dr.status = Status(int(status)) if int(status) else \
        Status.MAX_ITERATIONS_FAILURE
    self.time += self.timestep
    if self.recursive_prior_update:
      self._prior_update()
    return self.state

  @property
  def state(self):
    return np.concatenate([self.q_history[-1], self.qvel_est,
                           np.zeros(self.m.na)])

  @property
  def state_tensor(self):
    return self.upload(self.state)

  def set_state(self, state):
    nq, nv = self.m.nq, self.m.nv
    state = np.asarray(state)
    for t in range(self.cfg_len):
      self.q_history[t] = state[:nq].copy()
    self.qvel_est = state[nq:nq + nv].copy()
