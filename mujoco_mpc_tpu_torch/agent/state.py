"""Thread-safe state snapshot bridging physics and planner threads.

A lock-guarded snapshot of [qpos, qvel, act] + mocap + userdata + time,
written by the physics thread and read by the planner thread (the
reference's mjpc/states/state.{h,cc}). The payload is host numpy (cheap
lock-held copies); `set` reads the tensors of a Data back from the device,
and conversion to device tensors happens on the reader side.
"""

from __future__ import annotations

import threading

import numpy as np


def _host(x) -> np.ndarray:
  """A tensor (on any device) or array-like as a float64 numpy array."""
  if hasattr(x, "detach"):
    x = x.detach().cpu().numpy()
  return np.asarray(x, dtype=np.float64)


class State:
  """Locked snapshot of the simulation state."""

  def __init__(self, nq: int, nv: int, na: int, nmocap: int = 0,
               nuserdata: int = 0):
    self._lock = threading.RLock()
    self._state = np.zeros(nq + nv + na)
    self._mocap = np.zeros((max(nmocap, 1), 7))
    self._mocap[:, 3] = 1.0
    self._userdata = np.zeros(max(nuserdata, 1))
    self._time = 0.0

  def set(self, data):
    """Write from a Data of this package (or any object with its fields)."""
    with self._lock:
      parts = [_host(data.qpos), _host(data.qvel)]
      if getattr(data, "act", None) is not None:
        parts.append(_host(data.act))
      self._state = np.concatenate(parts)
      if getattr(data, "mocap_pos", None) is not None:
        mp = _host(data.mocap_pos).reshape(-1, 3)
        mq = _host(data.mocap_quat).reshape(-1, 4)
        n = min(len(mp), len(self._mocap))
        self._mocap[:n, :3] = mp[:n]
        self._mocap[:n, 3:] = mq[:n]
      if getattr(data, "userdata", None) is not None:
        ud = _host(data.userdata)
        self._userdata[:len(ud)] = ud
      self._time = float(_host(data.time))

  def copy_to(self):
    """Read a consistent snapshot: (state, mocap, userdata, time)."""
    with self._lock:
      return (self._state.copy(), self._mocap.copy(),
              self._userdata.copy(), self._time)

  @property
  def time(self) -> float:
    with self._lock:
      return self._time

  @property
  def state(self) -> np.ndarray:
    with self._lock:
      return self._state.copy()
