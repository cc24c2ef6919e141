"""Quadrotor flight to a mocap goal (the lane-kernel residual).

Four rotors are site-transmission actuators (a thrust along the rotor's z
axis and a yaw torque, `gear` 6-vectors). Residual: position error to the
mocap goal, world-frame linear and angular velocity, control minus the
hover thrust (total weight / 4). The pipeline `residual()` arrives with
the agent slice.
"""

from __future__ import annotations

import numpy as np

from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.tasks import base

QUAD_BODY = 1


class Quadrotor(base.Task):
  """Fly to the mocap goal."""

  name = "Quadrotor"
  asset = "quadrotor.npz"

  def lane_residual_spec(self):
    """In-kernel residual: 9 + nu rows; aux = the mocap goal (fixed per
    plan, d0.mocap_pos[0]); the device function is
    ops/csrc/residual_quadrotor.cuh."""
    m = self.plan_model
    quad = QUAD_BODY
    total_mass = float(np.sum(m.body_mass.cpu().numpy()))
    grav = float(np.linalg.norm(m.opt.gravity.cpu().numpy()))
    hover = total_mass * grav / int(m.nu)
    nu = int(m.nu)

    def fn(ctx):
      aux, xpos, xipos = ctx["aux"], ctx["xpos"], ctx["xipos"]
      ref, cvel, ctrl = ctx["ref"], ctx["cvel"], ctx["ctrl"]
      rows = [xpos[quad][k] - aux[k] for k in range(3)]
      ang, lin = cvel[quad]
      linv = lm.vadd(lin, lm.vcross(ang, lm.vsub(xipos[quad], ref[quad])))
      rows += [linv[k] for k in range(3)]
      rows += [ang[k] for k in range(3)]
      rows += [ctrl[u] - hover for u in range(nu)]
      return rows

    def make_aux(d0, params):
      return d0.mocap_pos[0]

    consts = [("quad_body", np.int32, np.array([quad])),
              ("hover", np.float32, np.array([hover]))]
    return dict(dim=9 + nu, naux=3, fn=fn, make_aux=make_aux,
                header="residual_quadrotor.cuh", consts=consts)
