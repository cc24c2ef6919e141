"""Sensor-style quantities that task residuals read, as pure functions of
(Model, Data after com_vel): what Walker's residual needs so far — a
body's velocity at its centre of mass and the centre-of-mass velocity of a
subtree (MuJoCo's subtreelinvel). The rest of the JAX package's
physics/sensors.py is ROADMAP queue 1 item 4.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics.model import Data, Model


def body_velocity(m: Model, d: Data, bodyid: int):
  """(linear, angular) world-frame velocity of a body at its com (xipos)."""
  ref = d.subtree_com[int(m.body_rootid[bodyid])]
  ang = d.cvel[bodyid, :3]
  lin = d.cvel[bodyid, 3:] + mm.cross(ang, d.xipos[bodyid] - ref)
  return lin, ang


def _is_descendant(m: Model, i: int, root: int) -> bool:
  while i > 0:
    if i == root:
      return True
    i = int(m.body_parentid[i])
  return root == 0


def _subtree_ids(m: Model, root: int) -> np.ndarray:
  """Bodies of the subtree rooted at `root`, in index order (the world
  body's subtree leaves out the world itself)."""
  return np.array([i for i in range(m.nbody) if _is_descendant(m, i, root)],
                  dtype=np.int64)


def subtree_linvel(m: Model, d: Data, root: int) -> torch.Tensor:
  """Mass-weighted average linear velocity of the subtree (subtreelinvel)."""
  lins, masses = [], []
  for b in _subtree_ids(m, root):
    lin, _ = body_velocity(m, d, int(b))
    lins.append(lin * m.body_mass[b])
    masses.append(m.body_mass[b])
  return sum(lins) / torch.clamp(sum(masses), min=1e-12)
