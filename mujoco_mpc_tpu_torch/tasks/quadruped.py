"""Quadruped locomotion task: the lane-kernel residual (Quadruped mode).

The full gait/mode machine of the task (modes Quadruped | Biped | Walk |
Scramble | Flip, automatic gait switching, the walk and flip trajectories)
is host-side state; what the rollout kernel scores is the Quadruped-mode
residual below, with all mode/gait dependence riding the residual
parameters and the per-call aux rows. The host-side `transition` and the
pipeline residual arrive with the agent loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.tasks import base

# modes
MODE_QUADRUPED, MODE_BIPED, MODE_WALK, MODE_SCRAMBLE, MODE_FLIP = range(5)
# gaits
GAIT_STAND, GAIT_WALK, GAIT_TROT, GAIT_CANTER, GAIT_GALLOP = range(5)

# gait phase signature per foot FL, HL, FR, HR
GAIT_PHASE = np.array([
    [0.00, 0.00, 0.00, 0.00],   # stand
    [0.00, 0.75, 0.50, 0.25],   # walk
    [0.00, 0.50, 0.50, 0.00],   # trot
    [0.00, 0.33, 0.33, 0.66],   # canter
    [0.00, 0.40, 0.05, 0.35],   # gallop
])
# per-gait parameters: duty, cadence, amplitude, balance w, upright w,
# height w
GAIT_PARAM = np.array([
    [1.00, 1.0, 0.00, 0.00, 1.0, 1.0],   # stand
    [0.75, 1.0, 0.03, 0.00, 1.0, 1.0],   # walk
    [0.45, 2.0, 0.03, 0.20, 1.0, 1.0],   # trot
    [0.40, 4.0, 0.05, 0.03, 0.5, 0.2],   # canter
    [0.30, 3.5, 0.10, 0.03, 0.2, 0.1],   # gallop
])
FOOT_RADIUS = 0.02
HEIGHT_QUADRUPED = 0.25
HEIGHT_BIPED = 0.6
POSTURE_GAIN = (2.0, 1.0, 1.0)  # abduction, hip, knee

# XML residual-param indices
P_GAIT = 0
P_GAIT_SWITCH = 1
P_CADENCE = 2
P_AMPLITUDE = 3
P_DUTY = 4
P_WALK_SPEED = 5
P_WALK_TURN = 6
P_FLIP_DIR = 7
P_BIPED_TYPE = 8
P_HEADING = 9
NPARAM_XML = 10
# appended mode-state slots (traced params so mode changes rebuild nothing)
S_MODE = 10
S_MODE_START = 11
S_PHASE_START = 12
S_PHASE_START_T = 13
S_PHASE_VEL = 14
S_FLIP_QUAT = 15    # 4 slots (w x y z): orientation at flip start
S_GROUND = 19
S_WALK_POS = 20     # 2 slots: rotation axis / origin
S_WALK_HEAD = 22    # 2 slots: axis->goal vector at walk start
NPARAM = 24


class QuadrupedFlat(base.Task):
  """Goal-seeking locomotion; lane path scores Quadruped mode."""

  name = "Quadruped Flat"
  asset = "quadruped_flat.npz"

  # the rollout kernel scores the Quadruped-mode residual only
  lane_modes = (MODE_QUADRUPED,)

  def __init__(self, **kw):
    super().__init__(**kw)
    names = self.model.names
    self._trunk = names["body"].index("trunk")
    self._head = names["site"].index("head")
    self._feet_geoms = [names["geom"].index(f"foot_{l}")
                        for l in ("fl", "hl", "fr", "hr")]
    # planning-contact whitelist: only the feet collide during candidate
    # rollouts (a reduced planning collision model)
    self.plan_contact_geoms = frozenset(self._feet_geoms)
    self._home_joints = np.asarray(self.home_qpos[7:], np.float32)

    # appended mode-state slots
    state0 = np.zeros(NPARAM - NPARAM_XML, np.float32)
    state0[S_MODE - NPARAM_XML] = MODE_QUADRUPED
    state0[S_PHASE_VEL - NPARAM_XML] = (
        2 * np.pi * float(self.residual_params[P_CADENCE]))
    state0[S_FLIP_QUAT - NPARAM_XML] = 1.0  # identity quat w
    self.residual_params = torch.cat(
        [self.residual_params, torch.as_tensor(state0).to(self.device)])

  def lane_residual_spec(self):
    """In-kernel residual for ops/step_lane.py.

    Returns the plain PyTorch residual on component lists (`fn`, the
    reference the CUDA device function in ops/csrc/residual_quadruped.cuh
    is held against), the device-function header and its constant table
    (`header`, `consts`), and `make_aux`. 42 rows: Upright 3, Height 1,
    Position 3, Gait 4, Balance 2, Effort 12, Posture 12, Orientation 2,
    Angmom 3. aux rows: [time0, goal_x, goal_y, phase0, phase_vel,
    amplitude, duty, cos(heading), sin(heading), footphase x4].
    """
    m = self.plan_model
    geom_pos = m.geom_pos.cpu().numpy()
    site_pos = m.site_pos.cpu().numpy()
    body_mass = m.body_mass.cpu().numpy()
    body_inertia = m.body_inertia.cpu().numpy()
    body_iquat = m.body_iquat.cpu().numpy()
    trunk = self._trunk
    feet = [(gid, int(m.geom_bodyid[gid])) for gid in self._feet_geoms]
    head_b = int(m.site_bodyid[self._head])
    head_p = [float(v) for v in site_pos[self._head]]
    home = self._home_joints
    gains = np.tile(np.asarray(POSTURE_GAIN), 4)
    ids = base.subtree_bodies(m, trunk)
    total_mass = max(sum(float(body_mass[b]) for b in ids), 1e-12)
    pi = float(np.pi)
    fall_time = float(np.sqrt(2.0 * HEIGHT_QUADRUPED / 9.81))

    def fn(ctx):
      cv, like = ctx["cv"], ctx["like"]
      qpos, aux = ctx["qpos"], ctx["aux"]
      xpos, xquat, xipos = ctx["xpos"], ctx["xquat"], ctx["xipos"]
      scom, ref, cvel = ctx["subtree_com"], ctx["ref"], ctx["cvel"]
      t, h = ctx["t"], ctx["h"]
      time = aux[0] + float(t) * h

      fp = [lm.vadd(xpos[b], lm.qrot(xquat[b], cv(list(geom_pos[gid]))))
            for gid, b in feet]
      avg = tuple(sum(p[k] for p in fp) * 0.25 for k in range(3))
      z = lm.qrot(xquat[trunk], cv([0.0, 0.0, 1.0]))
      rows = [z[2] - 1.0, like * 0.0, like * 0.0]
      rows.append(xipos[trunk][2] - avg[2] - HEIGHT_QUADRUPED)
      head = lm.vadd(xpos[head_b], lm.qrot(xquat[head_b], cv(head_p)))
      rows += [head[0] - aux[1], head[1] - aux[2], like * 0.0]
      phase = aux[3] + time * aux[4]
      amplitude, duty = aux[5], aux[6]
      for i in range(4):
        ang = phase - aux[9 + i]
        ang = torch.remainder(ang + pi, 2.0 * pi) - pi
        ang = ang * 0.5 / torch.clamp(1.0 - duty, min=1e-3)
        stp = torch.abs(torch.cos(torch.clamp(ang, -pi / 2, pi / 2)))
        stp = torch.where(stp < 1e-6, torch.zeros_like(stp), stp)
        stp = amplitude * torch.where(duty < 1.0, stp,
                                      torch.zeros_like(stp))
        target = FOOT_RADIUS + stp
        rows.append(torch.where(stp > 0, fp[i][2] - target, like * 0.0))
      # balance: capture point vs average foot position
      lins = {}
      for b in ids:
        ang_b, lin_b = cvel[b]
        lins[b] = (ang_b, lm.vadd(
            lin_b, lm.vcross(ang_b, lm.vsub(xipos[b], ref[b]))))
      comvel = tuple(
          sum(float(body_mass[b]) * lins[b][1][k] for b in ids) /
          total_mass for k in range(3))
      rows.append(scom[trunk][0] + fall_time * comvel[0] - avg[0])
      rows.append(scom[trunk][1] + fall_time * comvel[1] - avg[1])
      rows += [2e-2 * f for f in ctx["act_force"]]
      for i in range(len(home)):
        rows.append((qpos[7 + i] - float(home[i])) * float(gains[i]))
      hd = lm.qrot(xquat[trunk], cv([1.0, 0.0, 0.0]))
      nrm = torch.clamp(torch.sqrt(hd[0] ** 2 + hd[1] ** 2), min=1e-8)
      rows += [hd[0] / nrm - aux[7], hd[1] / nrm - aux[8]]
      # angular momentum of the subtree about its com
      am = [like * 0.0] * 3
      for b in ids:
        ang_b, lin_b = lins[b]
        r = lm.vsub(xipos[b], scom[trunk])
        dv = tuple(lin_b[k] - comvel[k] for k in range(3))
        orb = lm.vcross(r, dv)
        for k in range(3):
          am[k] = am[k] + float(body_mass[b]) * orb[k]
        q = lm.qmul(xquat[b], lm.const_quat(body_iquat[b], like))
        for kk in range(3):
          e = [0.0, 0.0, 0.0]
          e[kk] = 1.0
          ek = lm.qrot(q, cv(e))
          proj = ek[0] * ang_b[0] + ek[1] * ang_b[1] + ek[2] * ang_b[2]
          for k in range(3):
            am[k] = am[k] + float(body_inertia[b][kk]) * proj * ek[k]
      rows += am
      return rows

    gait_phase = torch.as_tensor(GAIT_PHASE.astype(np.float32)).to(
        self.device)

    def make_aux(d0, params):
      # a device-side gather: reading the gait on the host would make every
      # planner iteration wait for the card
      gait = params[P_GAIT].long().reshape(1)
      footphase = 2 * math.pi * gait_phase.index_select(0, gait)[0]
      # phase(t) = phase0 + (t - time0) * phase_vel, with t measured from
      # time0 inside the rollout
      phase0 = (params[S_PHASE_START] +
                (d0.time - params[S_PHASE_START_T]) * params[S_PHASE_VEL])
      return torch.cat([
          torch.stack([
              torch.zeros_like(phase0), d0.mocap_pos[0, 0],
              d0.mocap_pos[0, 1], phase0, params[S_PHASE_VEL],
              params[P_AMPLITUDE], params[P_DUTY],
              torch.cos(params[P_HEADING]), torch.sin(params[P_HEADING])]),
          footphase])

    ids_padded = np.zeros(m.nbody, np.int32)
    ids_padded[:len(ids)] = ids
    consts = [
        ("trunk", np.int32, np.array([trunk])),
        ("head_body", np.int32, np.array([head_b])),
        ("feet_body", np.int32, np.array([b for _, b in feet])),
        ("nids", np.int32, np.array([len(ids)])),
        ("ids", np.int32, ids_padded),
        ("head_pos", np.float32, np.array(head_p)),
        ("feet_pos", np.float32,
         np.array([geom_pos[gid] for gid, _ in feet])),
        ("home", np.float32, home),
        ("gains", np.float32, gains),
        ("total_mass", np.float32, np.array([total_mass])),
        ("fall_time", np.float32, np.array([fall_time])),
    ]
    return dict(dim=42, naux=13, fn=fn, make_aux=make_aux,
                header="residual_quadruped.cuh", consts=consts)
