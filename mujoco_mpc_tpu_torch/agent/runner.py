"""AgentRunner: a background planning thread and a lock-free action read
path.

The plan thread re-optimizes the policy from the newest state and publishes
each new plan's spline nodes to the native double-buffered policy host
(runtime/policy_runtime.cc); `action(time)` samples that host through
ctypes, with no torch, no lock and no device call on the path — the pattern
a 1 kHz servo loop embeds (the reference's AgentRunner C API,
mjpc/interface.cc). `set_state` only stores the control thread's state on
the host; the plan thread builds it into a Data on the planner's device at
the start of its next iteration, so the control thread never waits on the
card.

Only spline policies can be published: a planner whose policy is not a
spline (iLQG's time-indexed actions and gains, or iLQS, which switches to
them) is refused at construction.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.runtime import runtime as native


class AgentRunner:
  """Continuously planning agent with a lock-free action read path."""

  def __init__(self, task, planner=None, seed: int = 0):
    if planner is None:
      from mujoco_mpc_tpu_torch.agent.agent import Agent
      planner = Agent(task, seed=seed).planner
    pol = planner.policy
    if not isinstance(pol, spline_lib.SplinePolicy):
      refused = f"its policy is a {type(pol).__name__}"
    elif getattr(planner, "ilqg", None) is not None:
      refused = "its policy turns into iLQG's when iLQG wins"
    else:
      refused = None
    if refused is not None:
      raise NotImplementedError(
          f"AgentRunner publishes spline policies to the native host, and "
          f"{type(planner).__name__} cannot be published: {refused}, not a "
          "spline (use a sampling-family planner)")
    self.task = task
    self.planner = planner
    self.device = torch.device(planner.device)
    m = getattr(task, "plan_model", task.model)
    self._host = native.PolicyRuntime(nu=m.nu, num_nodes=pol.num_nodes,
                                      interp=int(pol.interp))
    ctrlrange = m.actuator_ctrlrange.cpu().numpy()
    self._host.set_ctrlrange(ctrlrange[:, 0], ctrlrange[:, 1])
    self._publish(pol)

    # used by the plan thread only
    self._gen = torch.Generator(device=self.device).manual_seed(seed)
    self._d0 = task.make_data()
    self._state_lock = threading.Lock()
    self._pending = {}
    self._exit = threading.Event()
    self._iterations = 0
    self._thread: Optional[threading.Thread] = None
    self.error: Optional[Exception] = None

  # -- control-thread API ----------------------------------------------------

  def set_state(self, qpos=None, qvel=None, time=None):
    """The newest physics state for the planner (host arrays or tensors);
    the plan thread takes it at the start of its next iteration."""
    new = {}
    for name, x in (("qpos", qpos), ("qvel", qvel), ("time", time)):
      if x is not None:
        new[name] = x
    with self._state_lock:
      self._pending.update(new)

  def action(self, time: float) -> np.ndarray:
    """The newest published policy at `time`, clamped to the ctrl range
    (native host: no torch, no lock)."""
    return self._host.action(float(time))

  @property
  def policy_version(self) -> int:
    return self._host.version

  @property
  def iterations(self) -> int:
    return self._iterations

  # -- plan thread -----------------------------------------------------------

  def _publish(self, pol):
    # t0, dt and the nodes in one read back from the device
    flat = torch.cat([pol.t0.reshape(1), pol.dt.reshape(1),
                      pol.values.reshape(-1)]).double().cpu().numpy()
    self._host.update(flat[0], flat[1], flat[2:].reshape(pol.values.shape))

  def _snapshot(self):
    """The planner's start state: the last one, with what set_state
    stored since built into it on the planner's device."""
    with self._state_lock:
      pending, self._pending = self._pending, {}
    if pending:
      d = self._d0
      self._d0 = d.replace(**{
          name: torch.as_tensor(x, dtype=torch.float32,
                                device=getattr(d, name).device).reshape(
                                    getattr(d, name).shape)
          for name, x in pending.items()})
    return self._d0

  def _plan_loop(self):
    try:
      while not self._exit.is_set():
        self.planner.optimize(self._gen, self._snapshot())
        self._publish(self.planner.policy)
        self._iterations += 1
    except Exception as e:  # noqa: BLE001  (kept for stop() to raise)
      self.error = e

  def start(self):
    if self._thread is not None:
      raise RuntimeError("already running")
    self._thread = threading.Thread(target=self._plan_loop, daemon=True)
    self._thread.start()
    return self

  def stop(self):
    """Stop the plan thread (it finishes its iteration, at most 30 s) and
    raise what stopped it early, if anything did."""
    self._exit.set()
    if self._thread is not None:
      self._thread.join(timeout=30.0)
      alive = self._thread.is_alive()
      self._thread = None
      if alive:
        raise RuntimeError("the plan thread did not stop within 30 s")
    if self.error is not None:
      raise self.error

  def __enter__(self):
    return self.start()

  def __exit__(self, *exc):
    self.stop()
