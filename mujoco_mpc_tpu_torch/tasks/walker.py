"""Walker task: a planar biped (rootx / rootz / rooty, two legs of thigh,
leg and foot capsules) standing or walking at a target speed.

Residuals Control(6), Height (torso height minus the goal), Rotation (the
torso z-axis's z component minus 1) and Speed (the com's forward velocity
minus the goal), quadratic norms; parameters Height Goal / Speed Goal.
Contacts: capsule feet, legs and torso against the floor plane and the
legs' capsules against each other (pyramidal, condim 3). The pipeline
`residual` drives iLQG's derivatives and the agent loop; the lane residual
is the rollout kernel's (ops/csrc/residual_walker.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.physics import sensors
from mujoco_mpc_tpu_torch.tasks import base
from mujoco_mpc_tpu_torch.tasks.humanoid import subtree_comvel

TORSO = 1   # the first body after the world


class Walker(base.Task):
  """Stand / walk at target speed."""

  name = "Walker"
  asset = "walker.npz"

  def residual(self, m, d, params: torch.Tensor) -> torch.Tensor:
    # slices, not 0-d tensors stacked: see physics/math.py
    height = d.xpos[TORSO, 2:3] - params[0:1]
    upright = d.xmat[TORSO, 2, 2:3] - 1.0
    speed = sensors.subtree_linvel(m, d, TORSO)[0:1] - params[1:2]
    return torch.cat([d.ctrl, height, upright, speed])

  def lane_residual_spec(self):
    """In-kernel residual for ops/step_lane.py: ctrl, torso height,
    uprightness (the torso z-axis's z) and the com's forward speed, from
    the step's kinematics and body velocities. aux = [height_goal,
    speed_goal]. nu + 3 rows; the device function is
    ops/csrc/residual_walker.cuh."""
    m = self.plan_model
    body_mass = m.body_mass.cpu().numpy()
    ids = list(range(1, m.nbody))
    total_mass = max(sum(float(body_mass[b]) for b in ids), 1e-12)

    def fn(ctx):
      xpos, xquat, aux = ctx["xpos"], ctx["xquat"], ctx["aux"]
      up = lm.qrot(xquat[TORSO], ctx["cv"]([0.0, 0.0, 1.0]))
      comvel = subtree_comvel(ctx, ids, body_mass, total_mass)
      return list(ctx["ctrl"]) + [xpos[TORSO][2] - aux[0], up[2] - 1.0,
                                  comvel[0] - aux[1]]

    def make_aux(d0, params):
      return params[:2]

    ids_padded = np.zeros(m.nbody, np.int32)
    ids_padded[:len(ids)] = ids
    consts = [("torso", np.int32, np.array([TORSO])),
              ("nids", np.int32, np.array([len(ids)])),
              ("ids", np.int32, ids_padded),
              ("total_mass", np.float32, np.array([total_mass]))]
    return dict(dim=m.nu + 3, naux=2, fn=fn, make_aux=make_aux,
                header="residual_walker.cuh", consts=consts)
