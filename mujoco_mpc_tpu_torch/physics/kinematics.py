"""Forward kinematics and com-frame quantities (mj_kinematics, mj_comPos,
mj_comVel semantics).

Loops over the static tree are Python loops; the per-body results are
collected in lists and stacked, so nothing is written in place and
`torch.func.jacfwd` / `vmap` trace the functions. Backward tree
accumulations are static-mask matrix products.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics.model import (BALL, FREE, HINGE, SLIDE,
                                                Data, Model)


def kinematics(m: Model, d: Data) -> Data:
  """Body / site frames from qpos."""
  qpos = d.qpos
  nb = m.nbody
  zero3 = torch.zeros(3, dtype=qpos.dtype, device=qpos.device)
  ident = mm.identity_quat(qpos.dtype, qpos.device)
  xpos = [zero3] * nb
  xquat = [ident] * nb
  xanchor = [zero3] * m.njnt
  xaxis = [zero3] * m.njnt
  for i in range(1, nb):
    mid = int(m.body_mocapid[i])
    if mid >= 0:
      xpos[i] = d.mocap_pos[mid]
      xquat[i] = mm.normalize_quat(d.mocap_quat[mid])
      continue
    pid = int(m.body_parentid[i])
    pos = xpos[pid] + mm.rot_vec_quat(xquat[pid], m.body_pos[i])
    quat = mm.mul_quat(xquat[pid], m.body_quat[i])
    ja = int(m.body_jntadr[i])
    for k in range(int(m.body_jntnum[i])):
      j = ja + k
      jtype = int(m.jnt_type[j])
      qadr = int(m.jnt_qposadr[j])
      jpos, jaxis = m.jnt_pos[j], m.jnt_axis[j]
      anchor = mm.rot_vec_quat(quat, jpos) + pos
      axis = mm.rot_vec_quat(quat, jaxis)
      if jtype == FREE:
        pos = qpos[qadr:qadr + 3]
        quat = mm.normalize_quat(qpos[qadr + 3:qadr + 7])
        anchor = pos
        axis = jaxis                            # global z, not rotated
      elif jtype == BALL:
        qloc = mm.normalize_quat(qpos[qadr:qadr + 4])
        quat = mm.mul_quat(quat, qloc)
        pos = anchor - mm.rot_vec_quat(quat, jpos)
      elif jtype == SLIDE:
        pos = pos + axis * (qpos[qadr] - m.qpos0[qadr])
      elif jtype == HINGE:
        qloc = mm.axis_angle_to_quat(
            jaxis, qpos[qadr:qadr + 1] - m.qpos0[qadr:qadr + 1])
        quat = mm.mul_quat(quat, qloc)
        pos = anchor - mm.rot_vec_quat(quat, jpos)
      xanchor[j] = anchor
      xaxis[j] = axis
    xpos[i] = pos
    xquat[i] = mm.normalize_quat(quat)

  xpos = torch.stack(xpos)
  xquat = torch.stack(xquat)
  empty = torch.zeros((0, 3), dtype=qpos.dtype, device=qpos.device)
  xanchor = torch.stack(xanchor) if m.njnt else empty
  xaxis = torch.stack(xaxis) if m.njnt else empty
  xmat = mm.quat_to_mat(xquat)
  xipos = xpos + mm.rot_vec_quat(xquat, m.body_ipos)
  ximat = mm.quat_to_mat(mm.mul_quat(xquat, m.body_iquat))
  bs = m.dev["site_bodyid"]
  site_xpos = xpos[bs] + mm.rot_vec_quat(xquat[bs], m.site_pos)
  site_xmat = mm.quat_to_mat(mm.mul_quat(xquat[bs], m.site_quat))
  return d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                   ximat=ximat, xanchor=xanchor, xaxis=xaxis,
                   site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: Model, d: Data) -> Data:
  """Subtree com, c-frame spatial inertia and dof axes."""
  like = d.qpos
  sub_sum = m.dev["subtree_mask"] @ (m.body_mass[:, None] * d.xipos)
  sub_mass = torch.clamp(m.body_subtreemass, min=1e-15)
  subtree_com = sub_sum / sub_mass[:, None]
  ref = subtree_com[m.dev["body_rootid"]]       # (nb, 3)

  iquat_world = mm.mul_quat(d.xquat, m.body_iquat)
  cinert = mm.transform_inertia(m.body_mass, m.body_inertia, iquat_world,
                                d.xipos - ref)
  cinert = cinert * m.dev["not_world"]

  # motion subspace per dof at the body's c-frame point
  zero3 = torch.zeros(3, dtype=like.dtype, device=like.device)
  eye3 = torch.eye(3, dtype=like.dtype, device=like.device)
  rows = []
  for j in range(m.njnt):
    jtype = int(m.jnt_type[j])
    bid = int(m.jnt_bodyid[j])
    offset = ref[bid] - d.xanchor[j]
    if jtype == HINGE:
      ax = d.xaxis[j]
      rows.append(torch.cat([ax, mm.cross(ax, offset)]))
    elif jtype == SLIDE:
      rows.append(torch.cat([zero3, d.xaxis[j]]))
    else:
      if jtype == FREE:
        for k in range(3):
          rows.append(torch.cat([zero3, eye3[k]]))
      axes = d.xmat[bid].transpose(-1, -2)      # rows: body axes in world
      for k in range(3):
        rows.append(torch.cat([axes[k], mm.cross(axes[k], offset)]))
  cdof = torch.stack(rows) if rows else torch.zeros(
      (0, 6), dtype=like.dtype, device=like.device)
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: Model, d: Data) -> Data:
  """Body spatial velocities and cdof time-derivatives: cvel[b] is the sum
  of cdof_j * qvel_j over the dofs supporting b; cdof_dot_j = vpre_j x
  cdof_j with vpre_j the mj_comVel pre-velocity (hinge/slide: all earlier
  path dofs; ball: the path before the joint; free rotations: own
  translations; free translations: zero)."""
  cdof_qvel = d.cdof * d.qvel[:, None]
  cvel = m.dev["body_dof_mask"] @ cdof_qvel
  vpre = m.dev["dof_pred_mask"] @ cdof_qvel
  cdof_dot = mm.motion_cross(vpre, d.cdof)
  cdof_dot = cdof_dot * (1.0 - m.dev["dof_cdofdot_zero"])[:, None]
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)
