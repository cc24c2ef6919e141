"""Rubik and Cube Solving: a hand turns the faces of a cube (the lane-kernel
residual).

A dexterous hand holds a cube whose six faces are hinged. Residual rows:
cube position to the palm site, cube orientation to the goal (the tangent
difference of the mocap goal quaternion and the cube's), cube linear
velocity, actuator force, the six face angles against their goals (zeroed
outside the Manual and Solve modes), hand posture against home, hand joint
velocity, and the remaining-goal cost (12 per remaining goal). Rubik is a
3-finger hand (9 actuators) around a cube core with six knob boxes; Cube
Solving a 20-actuator five-finger hand around a cube whose faces carry one
slab box each in the planning model.

The planning contacts are the JAX package's: the palm is a plane in the
planning model; Rubik keeps every capsule-capsule and capsule-box body pair
but drops the knob-knob box-box pairs (`plan_body_pair_types`); Cube
Solving keeps the fingertip capsules, the face slabs and the core
(`plan_contact_geoms`). The goal-stack mode machine (`transition`:
scramble, then solve face by face) and the pipeline `residual()` arrive
with the agent slice; the mode state already rides the residual
parameters (mode, goal index), so the lane residual reads it from aux
rows.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.physics import math as pmath
from mujoco_mpc_tpu_torch.physics.model import GEOM_BOX, GEOM_CAPSULE, \
    GEOM_SPHERE
from mujoco_mpc_tpu_torch.tasks import base

MODE_WAIT, MODE_MANUAL, MODE_SCRAMBLE, MODE_SOLVE = range(4)
# parameter layout: 6 face goals, the scramble count selection, then the
# appended mode state
P_FACES = 0
P_SCRAMBLE = 6
S_MODE = 7
S_GOAL_INDEX = 8
NPARAM = 9


def orientation_rows(cq, gq):
  """The cube's orientation error: the tangent difference quat_sub(goal,
  cube) = log(cube^-1 goal), shortest arc, in component form."""
  qd = lm.qmul((cq[0], -cq[1], -cq[2], -cq[3]), gq)
  sgn = torch.where(qd[0] < 0, -1.0, 1.0)
  qd = tuple(sgn * q for q in qd)
  sin_half = torch.sqrt(qd[1] ** 2 + qd[2] ** 2 + qd[3] ** 2 + 1e-18)
  angle = 2.0 * torch.atan2(sin_half, torch.clamp(qd[0], min=0.0))
  scale = angle / torch.clamp(sin_half, min=1e-12)
  return [qd[1 + k] * scale for k in range(3)]


def cube_consts(task, face_qadr: int) -> list:
  """The constant block of ops/csrc/cube_common.cuh: cube body and dof
  address, face address (Rubik), hand size, palm site position, home
  posture of the hand (padded to nq)."""
  m = task.plan_model
  home = np.zeros(m.nq, np.float32)
  home[:task._nhand] = task._home_hand
  return [
      ("cube_body", np.int32, np.array([task._cube_body])),
      ("cube_dadr", np.int32, np.array([task._cube_dadr])),
      ("face_qadr", np.int32, np.array([face_qadr])),
      ("nhand", np.int32, np.array([task._nhand])),
      ("palm_pos", np.float32, np.array(task._palm_pos)),
      ("home", np.float32, home),
  ]


class Rubik(base.Task):
  """Scramble-then-solve face turning with a goal-stack mode machine."""

  name = "Rubik"
  asset = "rubik.npz"
  # hand-cube contacts run in the rollout kernel; the 15 knob-knob box-box
  # pairs are simulation-only (a reduced planning contact set)
  plan_body_pairs = True
  plan_body_pair_types = frozenset({
      (GEOM_SPHERE, GEOM_SPHERE), (GEOM_SPHERE, GEOM_CAPSULE),
      (GEOM_CAPSULE, GEOM_CAPSULE), (GEOM_SPHERE, GEOM_BOX),
      (GEOM_CAPSULE, GEOM_BOX)})

  def __init__(self, **kw):
    super().__init__(**kw)
    names = self.model.names
    m = self.plan_model
    self._cube_body = names["body"].index("cube")
    palm_site = names["site"].index("palm_site")
    # the palm site is on the world body: its position is the world's
    self._palm_pos = [float(v) for v in m.site_pos.cpu().numpy()[palm_site]]
    # qpos layout: hand joints, the cube's free joint (7), faces (6); the
    # hand size is model-derived so that Cube Solving shares this class
    self._nhand = self.model.nq - 13
    self._home_hand = np.asarray(self.home_qpos[:self._nhand], np.float32)
    self._cube_qadr = self._cube_dadr = self._nhand
    self._face_qadr = self._nhand + 7
    self.residual_params = torch.cat([
        self.residual_params,
        torch.zeros(NPARAM - 7, dtype=torch.float32, device=self.device)])

  def lane_residual_spec(self):
    """In-kernel residual for ops/step_lane.py: 3 + 3 + 3 + nu + 6 +
    2 nhand + 1 rows; aux = [goal quaternion (4), face goals (6), mode gate,
    remaining-goal cost], so mode and goal changes rebuild nothing. The
    device function is ops/csrc/residual_rubik.cuh."""
    m = self.plan_model
    cube_b, da_c, qa_f = self._cube_body, self._cube_dadr, self._face_qadr
    nhand, nu = self._nhand, m.nu
    palm = self._palm_pos
    home = [float(v) for v in self._home_hand]

    def fn(ctx):
      qpos, qvel, aux = ctx["qpos"], ctx["qvel"], ctx["aux"]
      xpos, xquat = ctx["xpos"], ctx["xquat"]
      rows = [xpos[cube_b][k] - palm[k] for k in range(3)]
      rows += orientation_rows(xquat[cube_b], tuple(aux[:4]))
      rows += [qvel[da_c + k] for k in range(3)]
      rows += list(ctx["act_force"])
      rows += [aux[10] * (qpos[qa_f + i] - aux[4 + i]) for i in range(6)]
      rows += [qpos[i] - home[i] for i in range(nhand)]
      rows += [qvel[i] for i in range(nhand)]
      rows.append(aux[11] + 0.0 * qpos[0])
      return rows

    def make_aux(d0, params):
      gq = pmath.normalize_quat(d0.mocap_quat[0])
      mode = params[S_MODE]
      active = ((mode == MODE_MANUAL) | (mode == MODE_SOLVE)).to(gq.dtype)
      remaining = params[S_GOAL_INDEX] * 12.0
      return torch.cat([gq, params[P_FACES:P_FACES + 6], active[None],
                        remaining[None]])

    return dict(dim=3 + 3 + 3 + nu + 6 + 2 * nhand + 1, naux=12, fn=fn,
                make_aux=make_aux, header="residual_rubik.cuh",
                consts=cube_consts(self, qa_f))


class CubeSolving(Rubik):
  """The 20-actuator five-finger hand scrambling and solving a cube with
  articulated faces (registered as "Cube Solving")."""

  name = "Cube Solving"
  asset = "cube_solving.npz"

  def __init__(self, **kw):
    super().__init__(**kw)
    # planning contacts: the distal fingertip capsules against the face
    # slabs and the core (and the palm plane)
    names = self.plan_model.names["geom"]
    self.plan_contact_geoms = frozenset(
        i for i, n in enumerate(names)
        if n.startswith("ft_") or n.startswith("slab_") or n == "core")
