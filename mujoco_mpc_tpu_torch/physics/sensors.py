"""Sensors as pure functions of (Model, Data): the velocity quantities task
residuals read (a body's velocity at its centre of mass, a subtree's
centre-of-mass velocity and angular momentum), the post-constraint
com-based dynamics (mj_rnePostConstraint), and the general sensor
evaluation `make_sensor_fn` that the estimators and the Direct optimizer
read, as in the JAX package's physics/sensors.py.

The port has no `mujoco`, so `make_sensor_fn` builds the function from the
model's sensor table (`Model.sensors`, carried in the task record by
convert.py), whose mjtSensor / mjtObj values are those of the MuJoCo the
records were exported with (SENSOR_TYPES, OBJ_TYPES).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics.model import (GEOM_BOX, GEOM_CAPSULE,
                                                GEOM_CYLINDER,
                                                GEOM_ELLIPSOID, GEOM_PLANE,
                                                GEOM_SPHERE, Data, Model)

# mjtSensor values (MuJoCo 3.10)
SENSOR_TYPES = {
    "touch": 0, "accelerometer": 1, "velocimeter": 2, "gyro": 3,
    "force": 4, "torque": 5, "magnetometer": 6, "rangefinder": 7,
    "jointpos": 9, "jointvel": 10, "tendonpos": 11, "tendonvel": 12,
    "actuatorpos": 13, "actuatorvel": 14, "actuatorfrc": 15,
    "ballquat": 18, "ballangvel": 19, "framepos": 26, "framequat": 27,
    "framexaxis": 28, "frameyaxis": 29, "framezaxis": 30,
    "framelinvel": 31, "frameangvel": 32, "framelinacc": 33,
    "frameangacc": 34, "subtreecom": 35, "subtreelinvel": 36,
    "subtreeangmom": 37, "user": 48,
}
# mjtObj values of the frame sensors' objects
OBJ_TYPES = {"body": 1, "xbody": 2, "joint": 3, "geom": 5, "site": 6}

_SUPPORTED = frozenset(v for k, v in SENSOR_TYPES.items() if k != "user")
_ACC_STAGE = frozenset(SENSOR_TYPES[k] for k in (
    "touch", "accelerometer", "force", "torque"))
_NOT_PORTED = {SENSOR_TYPES["tendonpos"]: "tendonpos",
               SENSOR_TYPES["tendonvel"]: "tendonvel"}


def body_velocity(m: Model, d: Data, bodyid: int):
  """(linear, angular) world-frame velocity of a body at its com (xipos)."""
  ref = d.subtree_com[int(m.body_rootid[bodyid])]
  ang = d.cvel[bodyid, :3]
  lin = d.cvel[bodyid, 3:] + mm.cross(ang, d.xipos[bodyid] - ref)
  return lin, ang


def point_velocity(m: Model, d: Data, bodyid: int,
                   point: torch.Tensor) -> torch.Tensor:
  """World-frame linear velocity of a world-coordinates point on a body."""
  ref = d.subtree_com[int(m.body_rootid[bodyid])]
  ang = d.cvel[bodyid, :3]
  return d.cvel[bodyid, 3:] + mm.cross(ang, point - ref)


def site_velocity(m: Model, d: Data, siteid: int) -> torch.Tensor:
  return point_velocity(m, d, int(m.site_bodyid[siteid]),
                        d.site_xpos[siteid])


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


def subtree_com_of(m: Model, d: Data, root: int) -> torch.Tensor:
  return d.subtree_com[root]


def subtree_angmom(m: Model, d: Data, root: int) -> torch.Tensor:
  """Angular momentum of the subtree about its com (subtreeangmom)."""
  c = d.subtree_com[root]
  vc = subtree_linvel(m, d, root)
  total = torch.zeros(3, dtype=d.qpos.dtype, device=d.qpos.device)
  for b in _subtree_ids(m, root):
    b = int(b)
    lin, ang = body_velocity(m, d, b)
    # orbital term
    total = total + m.body_mass[b] * mm.cross(d.xipos[b] - c, lin - vc)
    # spin term: R diag(I) R^T w in the world frame
    rot = mm.quat_to_mat(mm.mul_quat(d.xquat[b], m.body_iquat[b]))
    total = total + rot @ (m.body_inertia[b] * (rot.transpose(0, 1) @ ang))
  return total


def rne_postconstraint(m: Model, d: Data):
  """com-based (cacc, cfrc_int, cfrc_ext) from the CONSTRAINED qacc
  (mj_rnePostConstraint): body spatial accelerations propagate qacc with
  a -gravity baseline; external wrenches collect xfrc_applied and the
  decoded contact forces; the internal body-parent wrench follows from
  each body's force balance, accumulated leaves to root. 6-vectors are
  (torque, force) at the reference point of the body's tree (subtree_com
  of its root). Needs Data after a full forward()."""
  from mujoco_mpc_tpu_torch.physics.smooth import DSBL_GRAVITY
  if d.qacc is None:
    raise ValueError("rne_postconstraint needs forward()-completed Data")
  dtype, device = d.qpos.dtype, d.qpos.device
  if m.opt.disableflags & DSBL_GRAVITY:
    gravity = torch.zeros(3, dtype=dtype, device=device)
  else:
    gravity = m.opt.gravity
  cacc_world = torch.cat([torch.zeros(3, dtype=dtype, device=device),
                          -gravity])
  cacc = cacc_world[None, :] + m.dev["body_dof_mask"] @ (
      d.cdof_dot * d.qvel[:, None] + d.cdof * d.qacc[:, None])

  rootid = m.dev["body_rootid"]
  ref = d.subtree_com[rootid]                       # (nb, 3)
  f_app = d.xfrc_applied[:, :3]
  t_app = d.xfrc_applied[:, 3:]
  cfrc_ext = torch.cat([t_app + mm.cross(d.xipos - ref, f_app), f_app],
                       dim=1)
  con = d.contact
  if con is not None and con.force is not None and con.dist.shape[0]:
    # world-frame force ON body2 (frame rows n, t1, t2, the normal from
    # geom1 to geom2)
    f_w = torch.einsum("cij,ci->cj", con.frame, con.force)
    for sign, bids in ((1.0, con.body2), (-1.0, con.body1)):
      refb = d.subtree_com[rootid[bids]]
      wrench = torch.cat([mm.cross(con.pos - refb, sign * f_w), sign * f_w],
                         dim=1)
      cfrc_ext = cfrc_ext.index_add(0, bids, wrench)

  iv = mm.inert_mul(d.cinert, d.cvel)
  cfrc_body = mm.inert_mul(d.cinert, cacc) + mm.force_cross(d.cvel, iv) - \
      cfrc_ext
  cfrc_body = cfrc_body * m.dev["not_world"]
  cfrc_int = m.dev["subtree_mask"] @ cfrc_body
  return cacc, cfrc_int, cfrc_ext


def object_acceleration(m: Model, d: Data, cacc: torch.Tensor, bodyid: int,
                        point: torch.Tensor):
  """(linear, angular) classical acceleration of a world point on a body
  (mj_objectAcceleration: spatial transform plus the w x v term)."""
  ref = d.subtree_com[int(m.body_rootid[bodyid])]
  ang = cacc[bodyid, :3]
  lin = cacc[bodyid, 3:] + mm.cross(ang, point - ref)
  w = d.cvel[bodyid, :3]
  return lin + mm.cross(w, point_velocity(m, d, bodyid, point)), ang


def _geom_frames(m: Model, d: Data):
  """(geom_xpos, geom_xmat): the kinematics' own where it made them (a
  model with candidate contacts), else from the body frames."""
  if d.geom_xpos is not None:
    return d.geom_xpos, d.geom_xmat
  bg = m.dev["geom_bodyid"]
  return (d.xpos[bg] + mm.rot_vec_quat(d.xquat[bg], m.geom_pos),
          mm.quat_to_mat(mm.mul_quat(d.xquat[bg], m.geom_quat)))


def _inside_site(m: Model, d: Data, siteid: int, pos: torch.Tensor):
  """Mask of the world points (n, 3) inside the site's volume (the touch
  sensor's zone; mju_insideGeom for the site's type and size)."""
  table = m.sensors
  local = (pos - d.site_xpos[siteid]) @ d.site_xmat[siteid]
  stype = int(table.site_type[siteid])
  size = [float(s) for s in table.site_size[siteid]]
  if stype == GEOM_SPHERE:
    return torch.sum(local ** 2, dim=1) <= size[0] ** 2
  if stype == GEOM_CAPSULE:
    z = torch.clamp(local[:, 2], -size[1], size[1])
    dd = torch.stack([local[:, 0], local[:, 1], local[:, 2] - z], dim=1)
    return torch.sum(dd ** 2, dim=1) <= size[0] ** 2
  if stype == GEOM_ELLIPSOID:
    return sum((local[:, i] / size[i]) ** 2 for i in range(3)) <= 1.0
  if stype == GEOM_CYLINDER:
    return (torch.abs(local[:, 2]) <= size[1]) & \
        (local[:, 0] ** 2 + local[:, 1] ** 2 <= size[0] ** 2)
  if stype == GEOM_BOX:
    return (torch.abs(local[:, 0]) <= size[0]) & \
        (torch.abs(local[:, 1]) <= size[1]) & \
        (torch.abs(local[:, 2]) <= size[2])
  raise ValueError(f"touch sensor site type {stype} unsupported")


def _touch(m: Model, d: Data, siteid: int) -> torch.Tensor:
  """Sum of the contact normal forces on the site's body whose contact
  point is inside the site's volume (mjSENS_TOUCH)."""
  con = d.contact
  if con is None or con.force is None or con.dist.shape[0] == 0:
    return torch.zeros(1, dtype=d.qpos.dtype, device=d.qpos.device)
  bid = int(m.site_bodyid[siteid])
  on_body = (con.body1 == bid) | (con.body2 == bid)
  inside = _inside_site(m, d, siteid, con.pos)
  f_n = torch.clamp(con.force[:, 0], min=0.0)
  return torch.sum(torch.where(on_body & inside, f_n,
                               torch.zeros_like(f_n)))[None]


def _ray_geom_dist(m: Model, gid: int, size, gp, gm, origin, direction):
  """Ray-geom distance (inf on a miss) for the primitive types plane,
  sphere, capsule and box (mju_rayGeom); other types let the ray pass."""
  gtype = int(m.geom_type[gid])
  big = torch.full((), float("inf"), dtype=origin.dtype, device=origin.device)
  zero = torch.zeros((), dtype=origin.dtype, device=origin.device)

  def sphere_t(center, r):
    oc = origin - center
    b = torch.dot(oc, direction)
    disc = b * b - (torch.dot(oc, oc) - r * r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 >= 0, t0, t1)
    return torch.where((disc >= 0) & (t >= 0), t, big)

  if gtype == GEOM_PLANE:
    n = gm[:, 2]
    denom = torch.dot(n, direction)
    t = -torch.dot(n, origin - gp) / torch.where(
        denom == 0, torch.full_like(denom, 1e-30), denom)
    return torch.where((torch.abs(denom) > 1e-12) & (t >= 0), t, big)
  if gtype == GEOM_SPHERE:
    return sphere_t(gp, size[0])
  if gtype == GEOM_CAPSULE:
    ax = gm[:, 2]
    r, hl = size[0], size[1]
    # the infinite cylinder's quadratic, its hit kept within the segment
    oc = origin - gp
    dproj = direction - torch.dot(direction, ax) * ax
    oproj = oc - torch.dot(oc, ax) * ax
    a = torch.dot(dproj, dproj)
    b = torch.dot(oproj, dproj)
    cc = torch.dot(oproj, oproj) - r * r
    disc = b * b - a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = (-b - sq) / torch.clamp(a, min=1e-12)
    z = torch.dot(oc + t_cyl * direction, ax)
    cyl_ok = (disc >= 0) & (a >= 1e-12) & (t_cyl >= 0) & (torch.abs(z) <= hl)
    t_c = torch.where(cyl_ok, t_cyl, big)
    return torch.minimum(t_c, torch.minimum(sphere_t(gp + hl * ax, r),
                                            sphere_t(gp - hl * ax, r)))
  if gtype == GEOM_BOX:
    o_l = gm.transpose(0, 1) @ (origin - gp)
    d_l = gm.transpose(0, 1) @ direction
    d_safe = torch.where(torch.abs(d_l) < 1e-12, torch.full_like(d_l, 1e-12),
                         d_l)
    # the half sizes filled on the device (a capture takes no host copy)
    s = torch.stack([origin.new_full((), v) for v in size[:3]])
    t1, t2 = (-s - o_l) / d_safe, (s - o_l) / d_safe
    tmin = torch.max(torch.minimum(t1, t2))
    tmax = torch.min(torch.maximum(t1, t2))
    t = torch.where(tmin >= 0, tmin, tmax)
    return torch.where((tmax >= torch.maximum(tmin, zero)) & (t >= 0), t, big)
  return big


def _rangefinder(m: Model, d: Data, siteid: int, geom_size) -> torch.Tensor:
  """Distance along the site's +Z axis to the nearest geom surface, -1
  when nothing is hit (mjSENS_RANGEFINDER; the geoms of the site's own
  body are left out, as mj_ray's bodyexclude does)."""
  origin = d.site_xpos[siteid]
  direction = d.site_xmat[siteid][:, 2]
  bid = int(m.site_bodyid[siteid])
  gxpos, gxmat = _geom_frames(m, d)
  ts = [_ray_geom_dist(m, g, geom_size[g], gxpos[g], gxmat[g], origin,
                       direction)
        for g in range(m.ngeom) if int(m.geom_bodyid[g]) != bid]
  if not ts:
    return -torch.ones(1, dtype=d.qpos.dtype, device=d.qpos.device)
  t = torch.min(torch.stack(ts))
  return torch.where(torch.isfinite(t), t, -torch.ones_like(t))[None]


def mat_to_quat(mat: torch.Tensor) -> torch.Tensor:
  """Rotation matrix -> unit quaternion (w, x, y, z), branch-free."""
  m00, m01, m02 = mat[0, 0], mat[0, 1], mat[0, 2]
  m10, m11, m12 = mat[1, 0], mat[1, 1], mat[1, 2]
  m20, m21, m22 = mat[2, 0], mat[2, 1], mat[2, 2]
  qw = torch.sqrt(torch.clamp(1.0 + m00 + m11 + m22, min=1e-12)) / 2
  qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2
  qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2
  qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2

  def sign(x):
    return torch.sign(torch.where(x == 0, torch.ones_like(x), x))

  q = torch.stack([qw, qx * sign(m21 - m12), qy * sign(m02 - m20),
                   qz * sign(m10 - m01)])
  return q / torch.clamp(mm.norm(q), min=1e-12)


def _type_name(stype: int) -> str:
  for k, v in SENSOR_TYPES.items():
    if v == stype:
      return k
  return f"mjtSensor {stype}"


def make_sensor_fn(m: Model, skip_user: bool = True, skip_types=()):
  """A pure function (Model, Data) -> sensordata built from `m`'s sensor
  table.

  The types the reference's tasks and estimators read: jointpos/jointvel,
  ball quat/angvel, actuator pos/vel/force, the frame sensors
  (pos/quat/axes/linvel/angvel/linacc/angacc) on bodies, sites and geoms,
  subtree com/linvel/angmom, gyro, velocimeter, magnetometer, touch,
  accelerometer, force, torque and rangefinder. User sensors (the cost
  terms) are skipped by default: residuals are functions of their own.
  tendonpos/tendonvel raise NotImplementedError (tendons are not ported);
  any other type raises ValueError at build time unless `skip_types`
  names it, when it reads zeros and is recorded in `fn.skipped`.
  Acceleration-stage sensors (touch, accelerometer, force, torque, frame
  accelerations) read the constrained qacc and the decoded contact
  forces: the Data must come from a full forward(); `fn.needs_acc` says
  whether any sensor of the table is one."""
  table = m.sensors
  if table is None:
    raise ValueError("the model has no sensor table (a record exported "
                     "without one)")
  names = (m.names or {}).get("sensor", [])
  user = SENSOR_TYPES["user"]
  specs, skipped = [], []
  for i in range(table.nsensor):
    stype = int(table.type[i])
    if skip_user and stype == user:
      continue
    name = names[i] if i < len(names) and names[i] else f"sensor{i}"
    if stype in _NOT_PORTED and stype not in skip_types:
      raise NotImplementedError(
          f"sensor '{name}' is a {_NOT_PORTED[stype]} sensor: tendons are "
          "not ported (the JAX package's physics/tendon.py)")
    if stype not in _SUPPORTED or stype in _NOT_PORTED:
      if stype not in skip_types:
        raise ValueError(
            f"sensor '{name}' has unsupported type {stype} "
            f"({_type_name(stype)}); pass skip_types=({stype},) to accept "
            "zeros for it explicitly")
      skipped.append((i, stype))
    specs.append((stype, int(table.objtype[i]), int(table.objid[i]),
                  int(table.dim[i]), i))
  ids = SENSOR_TYPES
  obj = OBJ_TYPES
  skip = {i for i, _ in skipped}
  acc_kinds = _ACC_STAGE | {ids["framelinacc"], ids["frameangacc"]}
  needs_acc = any(s[0] in acc_kinds and s[4] not in skip for s in specs)
  geom_size = [[float(v) for v in row]
               for row in m.geom_size.detach().cpu().numpy()]

  def frame_pos_mat(mm_, d, objtype, objid):
    if objtype == obj["body"]:
      return d.xipos[objid], d.ximat[objid], objid
    if objtype == obj["xbody"]:
      return d.xpos[objid], d.xmat[objid], objid
    if objtype == obj["site"]:
      return d.site_xpos[objid], d.site_xmat[objid], int(
          mm_.site_bodyid[objid])
    if objtype == obj["geom"]:
      gxpos, gxmat = _geom_frames(mm_, d)
      return gxpos[objid], gxmat[objid], int(mm_.geom_bodyid[objid])
    raise ValueError(f"frame objtype {objtype}")

  def sensor_fn(m, d):
    out = []
    cacc = cfrc_int = None
    if needs_acc:
      cacc, cfrc_int, _ = rne_postconstraint(m, d)
    for stype, objtype, objid, dim, idx in specs:
      if idx in skip:
        out.append(torch.zeros(dim, dtype=d.qpos.dtype,
                               device=d.qpos.device))
      elif stype == ids["jointpos"]:
        a = int(m.jnt_qposadr[objid])
        out.append(d.qpos[a:a + 1])
      elif stype == ids["jointvel"]:
        a = int(m.jnt_dofadr[objid])
        out.append(d.qvel[a:a + 1])
      elif stype == ids["ballquat"]:
        a = int(m.jnt_qposadr[objid])
        out.append(mm.normalize_quat(d.qpos[a:a + 4]))
      elif stype == ids["ballangvel"]:
        a = int(m.jnt_dofadr[objid])
        out.append(d.qvel[a:a + 3])
      elif stype == ids["actuatorpos"]:
        out.append(d.actuator_length[objid:objid + 1])
      elif stype == ids["actuatorvel"]:
        out.append(d.actuator_velocity[objid:objid + 1])
      elif stype == ids["actuatorfrc"]:
        out.append(d.actuator_force[objid:objid + 1])
      elif stype == ids["framepos"]:
        out.append(frame_pos_mat(m, d, objtype, objid)[0])
      elif stype == ids["framequat"]:
        out.append(mat_to_quat(frame_pos_mat(m, d, objtype, objid)[1]))
      elif stype in (ids["framexaxis"], ids["frameyaxis"],
                     ids["framezaxis"]):
        mat = frame_pos_mat(m, d, objtype, objid)[1]
        out.append(mat[:, stype - ids["framexaxis"]])
      elif stype == ids["framelinvel"]:
        p, _, bid = frame_pos_mat(m, d, objtype, objid)
        out.append(point_velocity(m, d, bid, p))
      elif stype == ids["frameangvel"]:
        out.append(d.cvel[frame_pos_mat(m, d, objtype, objid)[2], :3])
      elif stype == ids["framelinacc"]:
        p, _, bid = frame_pos_mat(m, d, objtype, objid)
        out.append(object_acceleration(m, d, cacc, bid, p)[0])
      elif stype == ids["frameangacc"]:
        out.append(cacc[frame_pos_mat(m, d, objtype, objid)[2], :3])
      elif stype == ids["subtreecom"]:
        out.append(subtree_com_of(m, d, objid))
      elif stype == ids["subtreelinvel"]:
        out.append(subtree_linvel(m, d, objid))
      elif stype == ids["subtreeangmom"]:
        out.append(subtree_angmom(m, d, objid))
      elif stype == ids["gyro"]:
        bid = int(m.site_bodyid[objid])
        out.append(d.site_xmat[objid].transpose(0, 1) @ d.cvel[bid, :3])
      elif stype == ids["velocimeter"]:
        v = site_velocity(m, d, objid)
        out.append(d.site_xmat[objid].transpose(0, 1) @ v)
      elif stype == ids["magnetometer"]:
        out.append(d.site_xmat[objid].transpose(0, 1) @ m.opt.magnetic)
      elif stype == ids["accelerometer"]:
        bid = int(m.site_bodyid[objid])
        lin, _ = object_acceleration(m, d, cacc, bid, d.site_xpos[objid])
        out.append(d.site_xmat[objid].transpose(0, 1) @ lin)
      elif stype == ids["force"]:
        bid = int(m.site_bodyid[objid])
        out.append(d.site_xmat[objid].transpose(0, 1) @ cfrc_int[bid, 3:])
      elif stype == ids["torque"]:
        bid = int(m.site_bodyid[objid])
        ref = d.subtree_com[int(m.body_rootid[bid])]
        tq = cfrc_int[bid, :3] - mm.cross(d.site_xpos[objid] - ref,
                                          cfrc_int[bid, 3:])
        out.append(d.site_xmat[objid].transpose(0, 1) @ tq)
      elif stype == ids["touch"]:
        out.append(_touch(m, d, objid))
      elif stype == ids["rangefinder"]:
        out.append(_rangefinder(m, d, objid, geom_size))
    if not out:
      return torch.zeros(0, dtype=d.qpos.dtype, device=d.qpos.device)
    return torch.cat(out)

  sensor_fn.skipped = skipped
  sensor_fn.needs_acc = needs_acc
  return sensor_fn
