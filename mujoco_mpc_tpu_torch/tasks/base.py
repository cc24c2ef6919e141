"""Task base: model + cost spec + residual hooks, built from a
compiled-task record.

A Task couples a compiled model with a residual and a cost built from
user-sensor specs. In this package a task does not compile MJCF itself:
it is built from a record (convert.task_record) that was exported once
from the compiled task and is stored under assets/, so running a task
needs no `mujoco`. A task adds what its ported paths need: the lane
residual spec of the rollout kernel, the pipeline `residual(m, d, params)`
of the derivative planners and of the agent loop, a host-side
`transition(d, rng)`. The base class carries what the agent's name-based
setters read: modes, selection options and the residual parameter names.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import model as model_lib

ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         os.pardir, "assets")


def subtree_bodies(m, root: int) -> list:
  """Bodies of the subtree rooted at `root` (itself included), in index
  order."""
  parent = np.asarray(m.body_parentid)
  out = []
  for b in range(m.nbody):
    a = b
    while a not in (0, root):
      a = int(parent[a])
    if a == root:
      out.append(b)
  return out


class Task:
  """Base class for tasks. Subclasses add residual hooks."""

  name: str = "Task"
  asset: str = None   # file name under assets/

  def __init__(self, device="cuda", record: Optional[dict] = None):
    self.device = model_lib.check_device(device)
    if record is None:
      path = os.path.join(ASSET_DIR, self.asset)
      with np.load(path, allow_pickle=False) as z:
        record = convert.record_from_npz(z)
    self.record = record
    self.model = convert.model_from_jax_numpy(record["model"], device)
    self.plan_model = convert.model_from_jax_numpy(record["plan_model"],
                                                   device)
    # planning model: agent_timestep overrides the simulation timestep
    agent_dt = self.config("agent_timestep", 0.0)
    if agent_dt > 0 and abs(agent_dt - float(self.model.opt.timestep)) > 1e-12:
      self.plan_model = self.plan_model.replace(
          opt=self.plan_model.opt.replace(timestep=torch.tensor(
              agent_dt, dtype=torch.float32, device=device)))
    # the constraint rows keep the `max_contact_points` deepest candidate
    # contacts (the JAX package's put_model reads the same numeric)
    max_contacts = int(self.config("max_contact_points", 32))
    self.model, self.plan_model = (
        model.replace(opt=model.opt.replace(max_contact_points=max_contacts))
        for model in (self.model, self.plan_model))
    self.cost_spec = self.default_cost_spec()
    self.residual_params = torch.as_tensor(
        np.array(record["residual_params"], np.float32)).to(device)
    self.mode = 0

  @classmethod
  def from_record(cls, record: dict, device="cuda") -> "Task":
    return cls(device=device, record=record)

  # -- modes and selections (the `task_transition` and `residual_list_*`
  # custom texts of the task's MJCF) ----------------------------------------

  def _text_list(self, name: str) -> list:
    data = self.record["texts"].get(name)
    if data:
      return [s for s in data.replace("\x00", "|").split("|") if s]
    return []

  @property
  def modes(self) -> list:
    return self._text_list("task_transition") or ["default"]

  @property
  def mode_name(self) -> str:
    modes = self.modes
    return modes[self.mode] if self.mode < len(modes) else modes[0]

  def set_mode_by_name(self, name: str):
    self.mode = self.modes.index(name)

  def selection_options(self, name: str) -> list:
    """Options of the residual_select_<name> parameter."""
    return self._text_list(f"residual_list_{name}")

  def set_selection(self, name: str, index: int):
    """Store option `index` in the residual_select_<name> parameter."""
    full = f"residual_select_{name}"
    if full not in self.residual_names:
      raise KeyError(name)
    params = self.residual_params.clone()
    params[self.residual_names.index(full)] = float(index)
    self.residual_params = params

  @property
  def residual_names(self) -> list:
    """Names of the `residual_*` numerics in MjModel order: entry i names
    residual_params[i]."""
    return list(self.record["residual_names"])

  def default_cost_spec(self):
    """The cost spec as the task's record holds it (the weights the MJCF
    sets), parsed afresh."""
    return convert.cost_spec_from_numpy(self.record["cost_spec"], self.device)

  def transition(self, d: model_lib.Data, rng) -> model_lib.Data:
    """Host-side per-control-step mode machine; `rng` is the caller's numpy
    generator for any random draw. Default: none."""
    return d

  def config(self, name: str, default):
    """First value of the custom numeric `name`, or `default`."""
    return self.record["numerics"].get(name, default)

  @property
  def home_qpos(self) -> Optional[np.ndarray]:
    home = self.record["keyframes"].get("home")
    return None if home is None else np.array(home)

  def make_data(self) -> model_lib.Data:
    d = model_lib.make_data(self.model)
    home = self.home_qpos
    if home is not None:
      d = d.replace(qpos=torch.as_tensor(
          home.astype(np.float32)).to(self.device))
    return d

  def cost(self, residual: torch.Tensor) -> torch.Tensor:
    return self.cost_spec.cost(residual)
