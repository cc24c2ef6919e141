"""Estimator interface and the ground-truth estimator.

Reference: mjpc/estimators/estimator.h (the Estimator interface, and
GroundTruth, which steps an internal model with the given controls), as the
JAX package's estimators/base.py.

`HostUpload` moves the host arrays an update takes (controls, noisy sensor
readings, window histories) to the card through pinned staging buffers, so
an update makes no synchronising copy from pageable memory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch.physics import forward as F


class HostUpload:
  """float32 host arrays -> new tensors on `device`. On a CUDA device the
  array is staged in one of `slots` pinned buffers and copied without
  blocking the host; a slot is written again only after its last copy
  has run (its CUDA event). On the CPU the array becomes a tensor."""

  def __init__(self, device, slots: int = 4):
    self.device = torch.device(device)
    self.cuda = self.device.type == "cuda"
    self.slots = [None] * slots
    self.next = 0

  def __call__(self, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.device.type == self.device.type:
      return x.to(torch.float32)
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    if not self.cuda:
      return torch.from_numpy(x.copy())
    i = self.next
    self.next = (i + 1) % len(self.slots)
    slot = self.slots[i]
    if slot is None or slot[0].numel() < x.size:
      slot = (torch.empty(max(x.size, 1), dtype=torch.float32,
                          pin_memory=True), torch.cuda.Event())
      self.slots[i] = slot
    else:
      slot[1].synchronize()
    buf, event = slot
    host = buf[:x.size]
    host.numpy()[:] = x.reshape(-1)
    out = torch.empty(x.shape, dtype=torch.float32, device=self.device)
    out.reshape(-1).copy_(host, non_blocking=True)
    event.record()
    return out


class Estimator:
  """Interface: reset / update(ctrl, sensor) / step(ctrl, sensor) / state /
  covariance."""

  def reset(self):
    raise NotImplementedError

  def update(self, ctrl, sensor):
    raise NotImplementedError

  def step(self, ctrl, sensor):
    """The agent's update after one simulation step under `ctrl`, with
    `sensor` read after that step. A filter whose `update` corrects before
    it predicts (the EKF's) predicts t -> t+1 first here; by default this
    is `update`."""
    return self.update(ctrl, sensor)

  @property
  def state(self) -> np.ndarray:
    """Packed [qpos, qvel, act] on the host."""
    raise NotImplementedError

  @property
  def state_tensor(self) -> torch.Tensor:
    """Packed [qpos, qvel, act] on the estimator's device."""
    raise NotImplementedError

  @property
  def covariance(self) -> Optional[np.ndarray]:
    return None

  def set_state(self, state):
    raise NotImplementedError


class GroundTruth(Estimator):
  """Open-loop propagation of an internal model (estimator.h GroundTruth):
  on a CUDA device the step is a CUDA graph of the pipeline step
  (`rollout.StepGraph`, as the agent's)."""

  def __init__(self, task, device=None):
    self.task = task
    self.m = task.model
    self.device = torch.device(task.device if device is None else device)
    if self.device.type == "cuda":
      self._step = rollout_lib.StepGraph(self.m)
    else:
      self._step = lambda d: F.step(self.m, d)
    self.upload = HostUpload(self.device)
    self.reset()

  def reset(self):
    self.data = self.task.make_data()

  def update(self, ctrl, sensor=None):
    del sensor
    self.data = self._step(self.data.replace(ctrl=self.upload(ctrl)))
    return self.state_tensor

  @property
  def state_tensor(self):
    return rollout_lib.pack_state(self.data)

  @property
  def state(self):
    return self.state_tensor.cpu().numpy()

  def set_state(self, state):
    self.data = rollout_lib.set_state(self.m, self.data, self.upload(state))
