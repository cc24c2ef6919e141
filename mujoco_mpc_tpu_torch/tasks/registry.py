"""Task registry: name -> task class, loaded from the committed records.

Only the tasks whose planner path is ported are registered; the others
arrive with their slices.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

_TASK_MODULES = [
    ("cartpole", ["Cartpole"]),
    ("hand", ["HandReorient"]),
    ("humanoid", ["HumanoidStand", "HumanoidWalk"]),
    ("quadrotor", ["Quadrotor"]),
    ("quadruped", ["QuadrupedFlat"]),
    ("rubik", ["Rubik", "CubeSolving"]),
    ("swimmer", ["Swimmer"]),
    ("tracking", ["HumanoidTracking"]),
    ("walker", ["Walker"]),
]


def get_task(name: str, **kwargs):
  _ensure_loaded()
  if name not in _REGISTRY:
    raise KeyError(
        f"unknown task {name!r}; available: {sorted(_REGISTRY)}")
  return _REGISTRY[name](**kwargs)


def task_names():
  _ensure_loaded()
  return sorted(_REGISTRY)


def _ensure_loaded():
  if _REGISTRY:
    return
  for modname, clsnames in _TASK_MODULES:
    mod = importlib.import_module(f"mujoco_mpc_tpu_torch.tasks.{modname}")
    for n in clsnames:
      cls = getattr(mod, n)
      _REGISTRY[cls.name] = cls
