"""Narrowphase geom collisions for the pipeline physics.

The candidate pairs are static: the compiled-task record lists every
potentially colliding geom pair once, grouped by (type1, type2) in the
order the JAX package's `make_collision_pairs` enumerates them, and every
pair is evaluated every step. Shapes stay fixed, so `torch.func.vmap` and
`torch.func.jacfwd` trace the functions and a CUDA graph can capture them.

Each narrowphase function takes the poses and sizes of the two geoms of a
group's pairs, (p1, m1, s1, p2, m2, s2) with the pair axis leading, and
returns (dist, pos, normal) with shapes (npair, ncon_per_pair),
(npair, ncon_per_pair, 3) and (npair, ncon_per_pair, 3). Normals point
from geom1 to geom2; the contact position is the midpoint between the
surfaces. The arithmetic is that of the JAX package's physics/collision.py,
including its approximations (an ellipsoid against a sphere or capsule is
a sphere of mean radius; a cylinder on a plane touches at three rim
points; box-box tests the vertices of each box against the other).

Height fields and meshes have no narrowphase here: `unsupported_groups`
names them and physics/forward.py refuses such models.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics.model import (GEOM_BOX, GEOM_CAPSULE,
                                                GEOM_CYLINDER,
                                                GEOM_ELLIPSOID, GEOM_HFIELD,
                                                GEOM_MESH, GEOM_PLANE,
                                                GEOM_SPHERE)

_TYPE_NAMES = {
    GEOM_PLANE: "plane", GEOM_HFIELD: "hfield", GEOM_SPHERE: "sphere",
    GEOM_CAPSULE: "capsule", GEOM_ELLIPSOID: "ellipsoid",
    GEOM_CYLINDER: "cylinder", GEOM_BOX: "box", GEOM_MESH: "mesh",
}


def _mat_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat @ v over the last axes, broadcasting the leading ones."""
  return torch.sum(mat * v[..., None, :], dim=-1)


def _mat_t_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat^T @ v over the last axes, broadcasting the leading ones."""
  return torch.sum(mat * v[..., :, None], dim=-2)


def _unit(axis: int, like: torch.Tensor) -> torch.Tensor:
  """The unit vector e_axis broadcast to the shape of `like`."""
  e = torch.zeros(3, dtype=like.dtype, device=like.device)
  e = torch.cat([e[:axis], torch.ones_like(e[:1]), e[axis + 1:]])
  return torch.zeros_like(like) + e


def _corners(like: torch.Tensor) -> torch.Tensor:
  """(8, 3) unit-box corners in the JAX package's order (x slowest), on
  the device of `like`; made from an arange, so no host copy enters a
  captured graph."""
  i = torch.arange(8, device=like.device)
  bits = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], dim=-1)
  return (2 * bits - 1).to(like.dtype)


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  r = s2[..., 0]
  h = torch.sum(n * (p2 - p1), dim=-1)
  dist = h - r
  pos = p2 - n * (r + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  r, hl = s2[..., 0], s2[..., 1]
  axis = m2[..., :, 2]
  ends = torch.stack([p2 + axis * hl[..., None], p2 - axis * hl[..., None]],
                     dim=-2)                                  # (..., 2, 3)
  h = torch.sum(n[..., None, :] * (ends - p1[..., None, :]), dim=-1)
  dist = h - r[..., None]
  pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
  nrm = torch.zeros_like(pos) + n[..., None, :]
  return dist, pos, nrm


def _plane_ellipsoid(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  # support point along -n: x = -E^2 n_loc / |E n_loc|
  n_loc = _mat_t_vec(m2, n)
  e = s2[..., :3]
  sp_loc = -e * e * n_loc / torch.sqrt(torch.clamp(
      torch.sum(e * e * n_loc * n_loc, dim=-1, keepdim=True), min=1e-12))
  sp = p2 + _mat_vec(m2, sp_loc)
  h = torch.sum(n * (sp - p1), dim=-1)
  pos = sp - 0.5 * h[..., None] * n
  return h[..., None], pos[..., None, :], n[..., None, :]


def _plane_cylinder(p1, m1, s1, p2, m2, s2):
  # three rim points on the end cap that faces the plane
  n = m1[..., :, 2]
  r, hl = s2[..., 0], s2[..., 1]
  axis = m2[..., :, 2]
  sign = -torch.sign(torch.sum(n * axis, dim=-1))
  cap = p2 + axis * (sign * hl)[..., None]
  # radial direction in the cap plane, most downhill
  t = n - axis * torch.sum(n * axis, dim=-1, keepdim=True)
  tn = mm.norm(t, keepdim=True)
  t = torch.where(tn > 1e-8, t / torch.clamp(tn, min=1e-8), m2[..., :, 0])
  b = mm.cross(axis, t)
  rr = r[..., None]
  pts = torch.stack([
      cap - t * rr,
      cap + (0.5 * t * rr + 0.866 * b * rr),
      cap + (0.5 * t * rr - 0.866 * b * rr),
  ], dim=-2)
  h = torch.sum(n[..., None, :] * (pts - p1[..., None, :]), dim=-1)
  pos = pts - 0.5 * h[..., None] * n[..., None, :]
  nrm = torch.zeros_like(pos) + n[..., None, :]
  return h, pos, nrm


def _plane_box(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  c = _corners(p1) * s2[..., None, :3]                        # (..., 8, 3)
  cw = p2[..., None, :] + _mat_vec(m2[..., None, :, :], c)
  h = torch.sum(n[..., None, :] * (cw - p1[..., None, :]), dim=-1)
  # the 4 deepest corners
  _, idx = torch.topk(-h, 4, dim=-1)
  hh = torch.gather(h, -1, idx)
  pts = torch.gather(cw, -2, idx[..., None].expand(*idx.shape, 3))
  pos = pts - 0.5 * hh[..., None] * n[..., None, :]
  nrm = torch.zeros_like(pos) + n[..., None, :]
  return hh, pos, nrm


def _sphere_sphere_raw(c1, r1, c2, r2, fallback_n):
  dvec = c2 - c1
  dn = mm.norm(dvec)
  n = torch.where(dn[..., None] > 1e-9,
                  dvec / torch.clamp(dn, min=1e-9)[..., None], fallback_n)
  dist = dn - r1 - r2
  pos = c1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  d, pos, n = _sphere_sphere_raw(p1, s1[..., 0], p2, s2[..., 0],
                                 _unit(2, p1))
  return d[..., None], pos[..., None, :], n[..., None, :]


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  r2, hl = s2[..., 0], s2[..., 1]
  axis = m2[..., :, 2]
  a = p2 - axis * hl[..., None]
  b = p2 + axis * hl[..., None]
  cp = mm.closest_segment_point(a, b, p1)
  d, pos, n = _sphere_sphere_raw(p1, s1[..., 0], cp, r2, _unit(2, p1))
  return d[..., None], pos[..., None, :], n[..., None, :]


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  r1, h1 = s1[..., 0], s1[..., 1]
  r2, h2 = s2[..., 0], s2[..., 1]
  ax1, ax2 = m1[..., :, 2], m2[..., :, 2]
  pa, pb = mm.closest_segment_segment(
      p1 - ax1 * h1[..., None], p1 + ax1 * h1[..., None],
      p2 - ax2 * h2[..., None], p2 + ax2 * h2[..., None])
  d, pos, n = _sphere_sphere_raw(pa, r1, pb, r2, _unit(2, p1))
  return d[..., None], pos[..., None, :], n[..., None, :]


def _sphere_box_raw(c, r, pb, mb, sb):
  """Sphere (centre c, radius r) against a box (pose pb / mb, half sizes
  sb); the normal points from the box surface toward the sphere centre."""
  half = sb[..., :3]
  loc = _mat_t_vec(mb, c - pb)
  clamped = torch.maximum(torch.minimum(loc, half), -half)
  # centre outside the box
  dvec = loc - clamped
  dn = mm.norm(dvec)
  outside = dn > 1e-9
  n_out = dvec / torch.clamp(dn, min=1e-9)[..., None]
  # centre inside: push toward the nearest face
  face_d = half - torch.abs(loc)
  k = torch.argmin(face_d, dim=-1)
  onehot = (k[..., None] == torch.arange(3, device=k.device)).to(c.dtype)
  sgn = torch.sign(torch.gather(loc, -1, k[..., None]))
  n_in = onehot * torch.where(sgn == 0, torch.ones_like(sgn), sgn)
  depth_in = -torch.gather(face_d, -1, k[..., None])[..., 0]
  cp_in = torch.where(onehot > 0.5, sgn * half, loc)
  dist_loc = torch.where(outside, dn, depth_in)
  n_loc = torch.where(outside[..., None], n_out, n_in)
  cp_loc = torch.where(outside[..., None], clamped, cp_in)
  n_w = _mat_vec(mb, n_loc)
  cp_w = pb + _mat_vec(mb, cp_loc)
  dist = dist_loc - r
  pos = cp_w + 0.5 * dist[..., None] * n_w
  return dist, pos, n_w


def _sphere_box(p1, m1, s1, p2, m2, s2):
  d, pos, n = _sphere_box_raw(p1, s1[..., 0], p2, m2, s2)
  # the normal points from geom1 (sphere) to geom2 (box)
  return d[..., None], pos[..., None, :], -n[..., None, :]


def _sphere_cylinder_raw(c, r, pc, mc, sc):
  """Sphere (centre c, radius r) against a solid cylinder (pose pc / mc,
  sc = [radius, half-height]): the exact closest point (side wall, flat
  cap or cap edge); the normal points from the cylinder toward the
  centre."""
  loc = _mat_t_vec(mc, c - pc)
  rad, hh = sc[..., 0], sc[..., 1]
  a = torch.sqrt(loc[..., 0] ** 2 + loc[..., 1] ** 2)
  az = loc[..., 2]
  safe_a = torch.clamp(a, min=1e-9)
  # closest point of the solid to an outside centre (the clamped form also
  # gives the cap-edge point)
  cp_xy = loc[..., :2] * (torch.minimum(a, rad) / safe_a)[..., None]
  cp_out = torch.cat(
      [cp_xy, torch.maximum(torch.minimum(az, hh), -hh)[..., None]], dim=-1)
  dvec = loc - cp_out
  dn = mm.norm(dvec)
  outside = dn > 1e-9
  n_out = dvec / torch.clamp(dn, min=1e-9)[..., None]
  # centre inside: push toward the nearer of side wall and cap
  side_d = rad - a
  cap_d = hh - torch.abs(az)
  use_side = side_d < cap_d
  nr_xy = loc[..., :2] / safe_a[..., None]
  zeros = torch.zeros_like(az)
  n_side = torch.cat([nr_xy, zeros[..., None]], dim=-1)
  sgnz = torch.where(az >= 0, torch.ones_like(az), -torch.ones_like(az))
  n_cap = torch.cat([torch.zeros_like(loc[..., :2]), sgnz[..., None]], dim=-1)
  n_in = torch.where(use_side[..., None], n_side, n_cap)
  cp_side = torch.cat([nr_xy * rad[..., None], az[..., None]], dim=-1)
  cp_cap = torch.cat([loc[..., :2], (sgnz * hh)[..., None]], dim=-1)
  cp_in = torch.where(use_side[..., None], cp_side, cp_cap)
  dist_loc = torch.where(outside, dn, -torch.minimum(side_d, cap_d))
  n_loc = torch.where(outside[..., None], n_out, n_in)
  cp_loc = torch.where(outside[..., None], cp_out, cp_in)
  n_w = _mat_vec(mc, n_loc)
  cp_w = pc + _mat_vec(mc, cp_loc)
  dist = dist_loc - r
  pos = cp_w + 0.5 * dist[..., None] * n_w
  return dist, pos, n_w


def _sphere_cylinder(p1, m1, s1, p2, m2, s2):
  d, pos, n = _sphere_cylinder_raw(p1, s1[..., 0], p2, m2, s2)
  # the normal points from geom1 (sphere) to geom2 (cylinder)
  return d[..., None], pos[..., None, :], -n[..., None, :]


def _capsule_box(p1, m1, s1, p2, m2, s2):
  r, hl = s1[..., 0], s1[..., 1]
  axis = m1[..., :, 2]
  ends = torch.stack([p1 - axis * hl[..., None], p1 + axis * hl[..., None]],
                     dim=-2)                                  # (..., 2, 3)
  d, pos, n = _sphere_box_raw(ends, r[..., None], p2[..., None, :],
                              m2[..., None, :, :], s2[..., None, :])
  return d, pos, -n


def _capsule_ellipsoid(p1, m1, s1, p2, m2, s2):
  # the ellipsoid as a sphere of its mean radius
  r2 = torch.mean(s2[..., :3], dim=-1)
  r1, hl = s1[..., 0], s1[..., 1]
  axis = m1[..., :, 2]
  cp = mm.closest_segment_point(p1 - axis * hl[..., None],
                                p1 + axis * hl[..., None], p2)
  d, pos, n = _sphere_sphere_raw(cp, r1, p2, r2, _unit(2, p1))
  return d[..., None], pos[..., None, :], n[..., None, :]


def _verts_vs_box(pa, ma, sa, pb, mb, sb, flip):
  """The 4 deepest vertices of box a against box b."""
  c = _corners(pa) * sa[..., None, :3]
  cw = pa[..., None, :] + _mat_vec(ma[..., None, :, :], c)
  d, pos, n = _sphere_box_raw(cw, torch.zeros_like(sa[..., 0:1]),
                              pb[..., None, :], mb[..., None, :, :],
                              sb[..., None, :])
  _, idx = torch.topk(-d, 4, dim=-1)
  ix3 = idx[..., None].expand(*idx.shape, 3)
  d4 = torch.gather(d, -1, idx)
  pos4 = torch.gather(pos, -2, ix3)
  n4 = torch.gather(n, -2, ix3)
  return d4, pos4, (n4 if flip else -n4)


def _box_box(p1, m1, s1, p2, m2, s2):
  # vertex-in-box tests both ways: 8 candidates, the 4 deepest each way
  d_a, pos_a, n_a = _verts_vs_box(p1, m1, s1, p2, m2, s2, flip=False)
  d_b, pos_b, n_b = _verts_vs_box(p2, m2, s2, p1, m1, s1, flip=True)
  return (torch.cat([d_a, d_b], dim=-1), torch.cat([pos_a, pos_b], dim=-2),
          torch.cat([n_a, n_b], dim=-2))


NARROWPHASE = {
    (GEOM_PLANE, GEOM_SPHERE): _plane_sphere,
    (GEOM_PLANE, GEOM_CAPSULE): _plane_capsule,
    (GEOM_PLANE, GEOM_ELLIPSOID): _plane_ellipsoid,
    (GEOM_PLANE, GEOM_CYLINDER): _plane_cylinder,
    (GEOM_PLANE, GEOM_BOX): _plane_box,
    (GEOM_SPHERE, GEOM_SPHERE): _sphere_sphere,
    (GEOM_SPHERE, GEOM_CAPSULE): _sphere_capsule,
    # the ellipsoid as a sphere of radius size[0] (the JAX package's table)
    (GEOM_SPHERE, GEOM_ELLIPSOID): _sphere_capsule,
    (GEOM_SPHERE, GEOM_CYLINDER): _sphere_cylinder,
    (GEOM_SPHERE, GEOM_BOX): _sphere_box,
    (GEOM_CAPSULE, GEOM_CAPSULE): _capsule_capsule,
    (GEOM_CAPSULE, GEOM_ELLIPSOID): _capsule_ellipsoid,
    (GEOM_CAPSULE, GEOM_BOX): _capsule_box,
    (GEOM_BOX, GEOM_BOX): _box_box,
}


def unsupported_groups(cp) -> list:
  """Pair groups of the collision record that have no narrowphase here
  (height fields and meshes), as readable names with their pair counts."""
  if cp is None:
    return []
  return [f"{_TYPE_NAMES.get(t1, t1)}-{_TYPE_NAMES.get(t2, t2)} "
          f"({g.count} pairs)"
          for g in cp.groups for t1, t2 in [g.types]
          if (t1, t2) not in NARROWPHASE]


def collide(m, d):
  """(dist (ncon,), pos (ncon, 3), normal (ncon, 3)) of every candidate
  contact, group by group in the record's order (that of the con_*
  arrays). Reads d.geom_xpos / d.geom_xmat (kinematics) and the pair
  groups' device index vectors (`m.dev["coll_groups"]`)."""
  cp = m.collision_pairs
  bad = unsupported_groups(cp)
  if bad:
    raise NotImplementedError(
        "no narrowphase for the pair groups " + ", ".join(bad) +
        " (height fields and meshes are not ported)")
  dists, poss, nrms = [], [], []
  for g, (i1, i2) in zip(cp.groups, m.dev["coll_groups"]):
    dist, pos, n = NARROWPHASE[g.types](
        d.geom_xpos[i1], d.geom_xmat[i1], m.geom_size[i1],
        d.geom_xpos[i2], d.geom_xmat[i2], m.geom_size[i2])
    dists.append(dist.reshape(-1))
    poss.append(pos.reshape(-1, 3))
    nrms.append(n.reshape(-1, 3))
  if not dists:
    z = torch.zeros((0,), dtype=d.qpos.dtype, device=d.qpos.device)
    return z, z.reshape(0, 3), z.reshape(0, 3)
  return torch.cat(dists), torch.cat(poss), torch.cat(nrms)


def make_contact_frame(n: torch.Tensor) -> torch.Tensor:
  """Contact frames (..., 3, 3), rows normal, tangent1, tangent2, from the
  normals: the first tangent is n x e, e the world axis x (y where
  |n_x| >= 0.5)."""
  ref = torch.where(torch.abs(n[..., 0:1]) < 0.5, _unit(0, n), _unit(1, n))
  t1 = mm.cross(n, ref)
  t1 = t1 / torch.clamp(mm.norm(t1, keepdim=True), min=1e-9)
  t2 = mm.cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)
