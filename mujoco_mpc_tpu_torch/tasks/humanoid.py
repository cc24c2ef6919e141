"""Humanoid tasks: Stand and Walk (the lane-kernel residual).

21-actuator humanoid (abdomen 3, 2x hip 3 + knee + 2 ankle, 2x shoulder 2
+ elbow) with capsule limbs, a sphere head and box feet on a plane. What
the rollout kernel scores: Height (head over the average of the four foot
sites, minus the goal), Balance (capture point vs average foot position),
CoM velocity (Walk tracks the forward speed goal, Stand passes 0), joint
velocity and control. The pipeline `residual()` arrives with the agent
slice (it needs the pipeline's sensors and contacts).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.tasks import base


def subtree_comvel(ctx, ids, body_mass, total_mass):
  """Linear velocity of the centre of mass of the bodies `ids`, from the
  step context's body velocities (component list)."""
  xipos, ref, cvel = ctx["xipos"], ctx["ref"], ctx["cvel"]
  comvel = [0.0, 0.0, 0.0]
  for b in ids:
    ang_b, lin_b = cvel[b]
    linv = lm.vadd(lin_b, lm.vcross(ang_b, lm.vsub(xipos[b], ref[b])))
    for k in range(3):
      comvel[k] = comvel[k] + float(body_mass[b]) * linv[k]
  return [v / total_mass for v in comvel]


def site_point(ctx, body: int, pos) -> tuple:
  """World position of a body-local point (component list)."""
  xpos, xquat = ctx["xpos"], ctx["xquat"]
  return lm.vadd(xpos[body], lm.qrot(xquat[body], ctx["cv"](pos)))


class HumanoidStand(base.Task):
  """Stand upright at target head height."""

  name = "Humanoid Stand"
  asset = "humanoid_stand.npz"
  # Stand's comvel rows are raw (no speed tracking); Walk tracks the speed
  _lane_tracks_speed = False

  def __init__(self, **kw):
    super().__init__(**kw)
    names = self.model.names
    self._torso = names["body"].index("torso")
    self._head = names["site"].index("head")
    self._feet_sites = [names["site"].index(f"sp_{s}_{p}")
                        for s in ("left", "right") for p in ("front", "back")]

  def _lane_geometry(self) -> dict:
    """Host constants the lane residuals of the humanoid tasks read: the
    head and foot sites (body, local position), the torso subtree and its
    mass."""
    m = self.plan_model
    site_pos = m.site_pos.cpu().numpy().astype(np.float64)
    site_bodyid = np.asarray(m.site_bodyid)
    body_mass = m.body_mass.cpu().numpy()
    ids = base.subtree_bodies(m, self._torso)
    return dict(
        feet=[(int(site_bodyid[s]), [float(v) for v in site_pos[s]])
              for s in self._feet_sites],
        head_b=int(site_bodyid[self._head]),
        head_p=[float(v) for v in site_pos[self._head]],
        ids=ids, body_mass=body_mass,
        total_mass=max(sum(float(body_mass[b]) for b in ids), 1e-12))

  def _geometry_consts(self, g: dict) -> list:
    m = self.plan_model
    ids_padded = np.zeros(m.nbody, np.int32)
    ids_padded[:len(g["ids"])] = g["ids"]
    return [
        ("torso", np.int32, np.array([self._torso])),
        ("head_body", np.int32, np.array([g["head_b"]])),
        ("feet_body", np.int32, np.array([b for b, _ in g["feet"]])),
        ("nids", np.int32, np.array([len(g["ids"])])),
        ("ids", np.int32, ids_padded),
        ("head_pos", np.float32, np.array(g["head_p"])),
        ("feet_pos", np.float32, np.array([p for _, p in g["feet"]])),
        ("total_mass", np.float32, np.array([g["total_mass"]])),
    ]

  def lane_residual_spec(self):
    """In-kernel residual for ops/step_lane.py, shared by Stand and Walk:
    aux = [height_goal, speed_goal]; the comvel rows are [comvel_x -
    speed_goal, comvel_y] (Stand passes speed_goal = 0, its raw comvel
    terms). 4 + (nv - 6) + nu rows; the device function is
    ops/csrc/residual_humanoid.cuh."""
    m = self.plan_model
    nv, nu = m.nv, m.nu
    g = self._lane_geometry()
    torso = self._torso

    def fn(ctx):
      aux, qvel, ctrl = ctx["aux"], ctx["qvel"], ctx["ctrl"]
      scom = ctx["subtree_com"]
      fps = [site_point(ctx, b, p) for b, p in g["feet"]]
      favg = tuple(sum(p[k] for p in fps) / len(fps) for k in range(3))
      head = site_point(ctx, g["head_b"], g["head_p"])
      rows = [head[2] - favg[2] - aux[0]]
      comvel = subtree_comvel(ctx, g["ids"], g["body_mass"],
                              g["total_mass"])
      dx = scom[torso][0] + 0.2 * comvel[0] - favg[0] + 1e-8
      dy = scom[torso][1] + 0.2 * comvel[1] - favg[1] + 1e-8
      rows.append(torch.sqrt(dx * dx + dy * dy))
      rows.append(comvel[0] - aux[1])
      rows.append(comvel[1])
      rows += [qvel[i] for i in range(6, nv)]
      rows += list(ctrl)
      return rows

    track_speed = self._lane_tracks_speed

    def make_aux(d0, params):
      speed = params[1] if track_speed and params.shape[0] > 1 \
          else torch.zeros_like(params[0])
      return torch.stack([params[0], speed])

    return dict(dim=4 + (nv - 6) + nu, naux=2, fn=fn, make_aux=make_aux,
                header="residual_humanoid.cuh",
                consts=self._geometry_consts(g))


class HumanoidWalk(HumanoidStand):
  """Walk forward at target speed."""

  name = "Humanoid Walk"
  asset = "humanoid_walk.npz"
  _lane_tracks_speed = True
