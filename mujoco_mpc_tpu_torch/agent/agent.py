"""Agent: owns a task and its planner; runs the plan/act loop.

The Agent couples the active planner with the task, exposes name-based
setters for cost weights, task parameters and modes, runs one planner
iteration from the current state (`plan_iteration`), and steps the
simulation (`step_env`; on the card one CUDA graph of the pipeline step,
`rollout.StepGraph`). `run` is the synchronous loop of the reference's
testspeed benchmark (plan every N physics steps); `agent/runner.py` is the
asynchronous plan thread with a lock-free action read path.

The planner is chosen by an explicit rule, `lane_eligibility`: on a CUDA
device a lane-eligible task takes the rollout kernel's predictive sampler
for "Sampling"; every other name builds its own planner
(`planners/base.make_planner`), whose routes on a CUDA device are its
kernels. Construction errors propagate: nothing falls back to another
planner. `routes` says which planner and kernels were taken, and why.

The estimator is "Ground Truth" (the planner sees the simulation's state)
or a filter, "Kalman", "Unscented" or "Batch" (estimators/): `step_env`
then feeds it the sensor reading after each step, with Gaussian noise of
`sensor_noise` from a numpy generator the Agent owns, and the planner
plans from the filter's state (`plan_data`). On the card each filter
update is one CUDA graph. `step_env` steps the simulation model on the
pipeline physics (joint limits, pyramidal primitive contacts): a task
whose simulation model needs more (elliptic cones, height fields, ...)
builds and plans, and `step_env` raises naming what is missing.
"""

from __future__ import annotations

import inspect
import logging
import time as time_lib
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import rollout as rollout_lib
from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.estimators import base as estimator_base
from mujoco_mpc_tpu_torch.ops import sampling_lane, step_lane
from mujoco_mpc_tpu_torch.physics import forward as F
from mujoco_mpc_tpu_torch.planners import base as planner_base

PLANNER_NAMES = planner_base.PLANNER_NAMES
ESTIMATOR_NAMES = ["Ground Truth", "Kalman", "Unscented", "Batch"]
SAMPLING_NAMES = ("Sampling", "Predictive Sampling")


def lane_eligibility(task, device) -> tuple:
  """(eligible, reason): may the agent plan `task` with the rollout
  kernel's predictive sampler on `device`? A pure function of the device
  type, the task's plan model, its lane residual hooks and its mode."""
  device = torch.device(device)
  if device.type != "cuda":
    return False, (f"device={device.type} (the rollout kernel runs on a "
                   "CUDA device; elsewhere the pipeline planners run)")
  missing = step_lane.unsupported(
      task.plan_model, ground_only=True,
      body_pairs=bool(getattr(task, "plan_body_pairs", False)))
  if missing is not None:
    return False, f"plan model outside the rollout kernel's class: {missing}"
  if not (hasattr(task, "lane_residual_spec")
          or hasattr(task, "residual_from_rollout")):
    return False, ("task has neither lane_residual_spec nor "
                   "residual_from_rollout")
  lane_modes = getattr(task, "lane_modes", None)
  if lane_modes is not None and int(task.mode) not in lane_modes:
    return False, (f"task mode {int(task.mode)} ({task.mode_name}) not in "
                   f"lane_modes={sorted(lane_modes)}")
  return True, "eligible"


def _action_takes_state(planner) -> bool:
  return "state" in inspect.signature(planner.action).parameters


class Agent:
  """Plan/act orchestration for one task on `device` (default: the
  task's). `seed` seeds the planner's torch.Generator, through seed + 1
  the numpy generator of the task's host transition, and through seed + 2
  the numpy generator of the sensor noise fed to a filter."""

  def __init__(self, task, planner: Optional[str] = None, seed: int = 0,
               estimator: Optional[str] = None, sensor_noise: float = 0.0,
               device=None):
    self.task = task
    self.device = torch.device(task.device if device is None else device)
    self.m = task.model
    self.timestep = float(self.m.opt.timestep)   # read once, on the host
    self.estimator_name = estimator or ESTIMATOR_NAMES[
        int(task.config("estimator", 0))]
    self._check_estimator(self.estimator_name)
    self.sensor_noise = float(sensor_noise)
    self.noise_rng = np.random.default_rng(seed + 2)
    name = planner or PLANNER_NAMES[int(task.config("agent_planner", 0))]
    self.planner_name = name
    self.gen = torch.Generator(device=self.device).manual_seed(seed)
    self.rng = np.random.default_rng(seed + 1)
    self.data = task.make_data()
    self._previous_policy = None
    # the simulation step: a CUDA graph on the card, eager on the CPU
    self._step = (rollout_lib.StepGraph(self.m)
                  if self.device.type == "cuda"
                  else lambda d: F.step(self.m, d))
    self.estimator = self._make_estimator(self.estimator_name)
    self._build_planner()

  # -- planner and estimator choice ------------------------------------------

  @staticmethod
  def _check_estimator(name):
    if name not in (None, "GroundTruth") and name not in ESTIMATOR_NAMES:
      raise ValueError(
          f"unknown estimator {name!r}; known: {ESTIMATOR_NAMES}")

  def _make_estimator(self, name):
    """None for "Ground Truth" (plan from the simulation's state), else the
    filter on the agent's device."""
    if name in (None, "Ground Truth", "GroundTruth"):
      return None
    if name == "Kalman":
      from mujoco_mpc_tpu_torch.estimators.kalman import Kalman
      est = Kalman(self.task, device=self.device)
    elif name == "Unscented":
      from mujoco_mpc_tpu_torch.estimators.unscented import Unscented
      est = Unscented(self.task, device=self.device)
    else:
      from mujoco_mpc_tpu_torch.estimators.batch import Batch
      est = Batch(self.task, device=self.device)
    self._sensor_fn = est.sensor_fn
    self._upload = estimator_base.HostUpload(self.device)
    return est

  def set_estimator(self, name: str):
    self._check_estimator(name)
    self.estimator_name = name
    self.estimator = self._make_estimator(name)

  def _build_planner(self):
    eligible, reason = lane_eligibility(self.task, self.device)
    if self.planner_name in SAMPLING_NAMES and eligible:
      planner = sampling_lane.LaneSamplingPlanner(self.task,
                                                  device=self.device)
    else:
      planner = planner_base.make_planner(self.task, self.planner_name,
                                          self.device)
    self.planner = planner
    self._planner_takes_state = _action_takes_state(planner)
    self.routes = dict(planner=type(planner).__name__, lane_eligible=eligible,
                       lane_reason=reason, **planner.routes)
    logging.getLogger(__name__).info(
        "planner build: task=%s planner=%s routes=%s", self.task.name,
        self.planner_name, self.routes)

  def _on_lane(self) -> bool:
    return (isinstance(self.planner, sampling_lane.LaneSamplingPlanner)
            or bool(getattr(self.planner, "lane", False)))

  # -- control loop ----------------------------------------------------------

  def plan_data(self):
    """The Data the planner sees: the filter's state when there is one
    (the reference's SetState from its estimator loop), else the true
    state."""
    if self.estimator is None:
      return self.data
    return rollout_lib.set_state(self.m, self.data,
                                 self.estimator.state_tensor)

  def reset(self):
    """Fresh data, a fresh planner (its nominal policy from scratch) and
    the filter reset."""
    self.data = self.task.make_data()
    self._previous_policy = None
    self._build_planner()
    if self.estimator is not None:
      self.estimator.reset()

  def plan_iteration(self, noise=None, u=None):
    """One planner iteration from the current state. The agent's generator
    advances with every draw; `noise` / `u` (pre-drawn numbers, for tests)
    go to the planner's optimize as its noise= / u= arguments."""
    self._previous_policy = getattr(self.planner, "policy", None)
    kw = {}
    if noise is not None:
      kw["noise"] = noise
    if u is not None:
      kw["u"] = u
    return self.planner.optimize(self.gen, self.plan_data(), **kw)

  def action(self) -> torch.Tensor:
    """The policy's action at the current time; planners with feedback
    (iLQG, iLQS) also get the current state."""
    if self._planner_takes_state:
      d = self.plan_data()
      state = torch.cat([d.qpos, d.qvel, d.act])
      return self.planner.action(self.data.time, state=state)
    return self.planner.action(self.data.time)

  def action_previous(self) -> torch.Tensor:
    """The action of the policy as it was before the last plan iteration."""
    prev = self._previous_policy
    if prev is None:
      return self.action()
    if isinstance(prev, spline_lib.SplinePolicy):
      u = spline_lib.sample(prev, self.data.time)
      lo, hi = self.m.actuator_ctrlrange[:, 0], self.m.actuator_ctrlrange[:, 1]
      return torch.minimum(torch.maximum(u, lo), hi)
    cur = self.planner.policy
    self.planner.policy = prev
    u = self.action()
    self.planner.policy = cur
    return u

  def step_env(self, action=None):
    """Advance the simulation one physics step under the policy's action
    (or `action`), then the task's host transition."""
    missing = F.unsupported(self.m)
    if missing:
      raise NotImplementedError(
          f"step_env: the pipeline physics cannot step {self.task.name}'s "
          f"simulation model, which needs: {'; '.join(missing)} (contacts "
          "in the pipeline physics are ROADMAP queue 1 items 3-4)")
    if action is None:
      u = self.action()
    else:
      u = torch.as_tensor(action, dtype=torch.float32).to(self.device)
    self.data = self._step(self.data.replace(ctrl=u))
    self.data = self.task.transition(self.data, self.rng)
    if self.estimator is not None:
      self._feed_estimator(u)

  def _feed_estimator(self, u):
    """The filter's step (`Estimator.step`) from the sensor reading after
    the simulation step (on the stepped Data, as the JAX agent reads it),
    plus the agent's noise: the reading is taken after the step, so a
    filter predicts t -> t+1 under u and then corrects with it (the JAX
    agent's order)."""
    y = self._sensor_fn(self.m, self.data)
    if self.sensor_noise > 0.0:
      y = y + self._upload(self.noise_rng.normal(
          scale=self.sensor_noise, size=tuple(y.shape)))
    self.estimator.step(u, y)

  def run(self, total_time: float, steps_per_plan: int = 4,
          pipelined_plan: bool = False):
    """Synchronous plan/act loop (testspeed semantics): plan every
    `steps_per_plan` physics steps of the simulation model.

    Outside pipelined mode each plan is timed up to a device synchronise;
    with pipelined_plan=True the plan's launches overlap the next step's
    dispatch in this one thread. Each step's cost, action and state come to
    the host in one read. Returns costs, actions, plan_times and avg_cost
    (as the JAX package's run), plus states ([qpos, qvel] a step) and
    step_times (seconds from each step_env's call until the step's cost,
    action and state are on the host: the read waits for the device)."""
    n_steps = int(round(total_time / self.timestep))
    nu = self.m.nu
    costs, actions, states, plan_times, step_times = [], [], [], [], []
    for t in range(n_steps):
      if t % steps_per_plan == 0:
        t0 = time_lib.perf_counter()
        self.plan_iteration()
        if not pipelined_plan:
          if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
          plan_times.append(time_lib.perf_counter() - t0)
      t0 = time_lib.perf_counter()
      self.step_env()
      d = self.data
      r = self.task.residual(self.m, d, self.task.residual_params)
      row = torch.cat([self.task.cost(r).reshape(1), d.ctrl, d.qpos,
                       d.qvel]).cpu().numpy()
      step_times.append(time_lib.perf_counter() - t0)
      costs.append(float(row[0]))
      actions.append(row[1:1 + nu])
      states.append(row[1 + nu:])
    return {
        "costs": np.array(costs),
        "actions": np.array(actions),
        "plan_times": np.array(plan_times),
        "avg_cost": float(np.mean(costs)),
        "states": np.array(states),
        "step_times": np.array(step_times),
    }

  # -- name-based setters ----------------------------------------------------

  def set_cost_weight(self, name: str, value: float):
    # the planners read task.cost_spec at every iteration: nothing rebuilds
    self.task.cost_spec = self.task.cost_spec.set_weight(name, value)

  def reset_cost_weights(self):
    self.task.cost_spec = self.task.default_cost_spec()

  def set_task_parameter_selection(self, name: str, value: str):
    """Selection parameters (residual_select_*): store the option index."""
    options = self.task.selection_options(name)
    self.task.set_selection(name, options.index(value))

  def get_task_parameters(self) -> dict:
    values = self.task.residual_params.cpu().numpy()
    return {nm[len("residual_"):]: float(values[i])
            for i, nm in enumerate(self.task.residual_names)}

  def set_task_parameter(self, name: str, value: float):
    full = f"residual_{name}"
    if full not in self.task.residual_names:
      raise KeyError(name)
    params = self.task.residual_params.clone()
    params[self.task.residual_names.index(full)] = float(value)
    self.task.residual_params = params

  def get_cost_weights(self) -> dict:
    cs = self.task.cost_spec
    return dict(zip(cs.term_names, cs.weights.cpu().numpy()))

  def get_cost_term_values(self, weighted: bool = True) -> dict:
    d = self.data
    if d.xpos is None:         # residuals need the kinematics
      d = F.forward(self.m, d)
      self.data = d
    r = self.task.residual(self.m, d, self.task.residual_params)
    terms = self.task.cost_spec.cost_terms(r, weighted=weighted)
    return dict(zip(self.task.cost_spec.term_names, terms.cpu().numpy()))

  def set_mode(self, mode: str):
    """Switch the task's mode; a lane planner whose task leaves its
    lane_modes is rebuilt through the eligibility rule."""
    was_lane = self._on_lane()
    self.task.set_mode_by_name(mode)
    lane_modes = getattr(self.task, "lane_modes", None)
    if was_lane and lane_modes is not None and \
        int(self.task.mode) not in lane_modes:
      self._build_planner()

  def get_mode(self) -> str:
    return self.task.mode_name

  def get_all_modes(self):
    return self.task.modes

  def best_trajectory(self) -> dict:
    """Rollout of the current policy from the current state on the pipeline
    physics (the reference's BestTrajectory)."""
    horizon = getattr(getattr(self.planner, "config", None), "horizon", 50)
    residual_fn = lambda m, d: self.task.residual(
        m, d, self.task.residual_params)
    traj = rollout_lib.rollout(
        self.m, residual_fn, self.task.cost_spec.cost,
        lambda state, time: self.planner.action(time), self.data, horizon)
    return {
        "states": traj.states.cpu().numpy(),
        "actions": traj.actions.cpu().numpy(),
        "times": traj.times.cpu().numpy(),
        "steps": horizon,
    }

  def save_trajectory_html(self, path: str) -> str:
    raise NotImplementedError(
        "save_trajectory_html needs the trajectory viewer "
        "(utils/viewer.py), which is not ported yet (ROADMAP queue 1 "
        "item 7)")
