"""Hand Reorient: turn a free cube in a 20-actuator five-finger hand to the
goal orientation (the lane-kernel residual).

Residual rows: cube position to the palm site, cube orientation to the
mocap goal (tangent difference), cube linear velocity, actuator force,
hand posture against home, hand joint velocity. The planning contacts are
the JAX package's: the palm is a plane in the planning model, and the
distal fingertip capsules touch the cube through body-body pairs
(`plan_contact_geoms`). The pipeline `residual()` arrives with the agent
slice.
"""

from __future__ import annotations

import numpy as np

from mujoco_mpc_tpu_torch.physics import math as pmath
from mujoco_mpc_tpu_torch.tasks import base
from mujoco_mpc_tpu_torch.tasks.rubik import cube_consts, orientation_rows


class HandReorient(base.Task):
  """Reorient the cube to the goal orientation."""

  name = "Hand Reorient"
  asset = "hand_reorient.npz"
  plan_body_pairs = True

  def __init__(self, **kw):
    super().__init__(**kw)
    names = self.model.names
    m = self.plan_model
    self._cube_body = names["body"].index("cube")
    palm_site = names["site"].index("palm_site")
    self._palm_pos = [float(v) for v in m.site_pos.cpu().numpy()[palm_site]]
    self._nhand = self.model.nq - 7  # 20 finger joints
    self._cube_dadr = self._nhand
    self._home_hand = np.asarray(self.home_qpos[:self._nhand], np.float32)
    geoms = m.names["geom"]
    self.plan_contact_geoms = frozenset(
        i for i, n in enumerate(geoms)
        if n.startswith("ft_") or n == "cube_geom")

  def lane_residual_spec(self):
    """In-kernel residual for ops/step_lane.py: 9 + nu + 2 nhand rows;
    aux = the goal quaternion. The device function is
    ops/csrc/residual_hand.cuh."""
    m = self.plan_model
    cube_b, da_c, nhand = self._cube_body, self._cube_dadr, self._nhand
    palm = self._palm_pos
    home = [float(v) for v in self._home_hand]

    def fn(ctx):
      qpos, qvel, aux = ctx["qpos"], ctx["qvel"], ctx["aux"]
      xpos, xquat = ctx["xpos"], ctx["xquat"]
      rows = [xpos[cube_b][k] - palm[k] for k in range(3)]
      rows += orientation_rows(xquat[cube_b], tuple(aux[:4]))
      rows += [qvel[da_c + k] for k in range(3)]
      rows += list(ctx["act_force"])
      rows += [qpos[i] - home[i] for i in range(nhand)]
      rows += [qvel[i] for i in range(nhand)]
      return rows

    def make_aux(d0, params):
      return pmath.normalize_quat(d0.mocap_quat[0])

    return dict(dim=9 + m.nu + 2 * nhand, naux=4, fn=fn, make_aux=make_aux,
                header="residual_hand.cuh", consts=cube_consts(self, 0))
