"""Quaternion / rotation / spatial-vector algebra for the pipeline physics.

Plain functions on tensors with the component on the last axis, written so
that `torch.func.jacfwd` and `torch.func.vmap` trace them (no in-place
writes, no data-dependent Python branches). Conventions follow MuJoCo:

  * quaternions are (w, x, y, z), unit norm, and rotate local -> world;
  * spatial (6D) vectors are ordered (angular[3], linear[3]), expressed in
    the world frame at a stated point (the "c-frame" convention of
    cvel/cdof/cinert).

The segment routines at the end serve the collision narrowphase
(physics/collision.py).
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis (broadcasting)."""
  ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
  bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
  return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                      ax * by - ay * bx], dim=-1)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
  return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def mul_quat(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product u * v."""
  w1, x1, y1, z1 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
  w2, x2, y2, z2 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], dim=-1)


def neg_quat(q: torch.Tensor) -> torch.Tensor:
  """Conjugate (inverse for unit quaternions)."""
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def identity_quat(dtype, device) -> torch.Tensor:
  """[1, 0, 0, 0], filled on the device: a tensor literal would be a copy
  from host memory, which synchronises the stream on every call."""
  return torch.cat([torch.ones(1, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device)])


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  n = norm(q, keepdim=True)
  ident = torch.zeros_like(q) + identity_quat(q.dtype, q.device)
  return torch.where(n > eps, q / torch.clamp(n, min=eps), ident)


def rot_vec_quat(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector v by quaternion q (local -> world)."""
  w = q[..., 0:1]
  u = q[..., 1:4]
  uv = cross(u, v)
  return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> 3x3 rotation matrix (world-from-local)."""
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  r = torch.stack([
      1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
  ], dim=-1)
  return r.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor
                       ) -> torch.Tensor:
  """Quaternion for rotation of `angle` radians about unit `axis`; `angle`
  keeps a trailing axis of length 1. (Tensors here never drop to zero
  dimensions and get an axis back: under vmap of jacfwd that sequence has
  been seen to promote float32 to float64.)"""
  half = 0.5 * angle
  return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt
                   ) -> torch.Tensor:
  """q <- q * exp(omega*dt/2) (mju_quatIntegrate)."""
  angle = norm(omega_local, keepdim=True)
  axis = omega_local / torch.clamp(angle, min=1e-12)
  dq = axis_angle_to_quat(axis, angle * dt)
  return normalize_quat(mul_quat(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """3D tangent-space difference: velocity v with qb * exp(v/2) = qa
  (mju_subQuat), local frame."""
  qd = normalize_quat(mul_quat(neg_quat(qb), qa))
  sign = torch.where(qd[..., 0:1] < 0, -torch.ones_like(qd[..., 0:1]),
                     torch.ones_like(qd[..., 0:1]))
  qd = qd * sign
  # v = xyz * angle / sin_half. The square root's derivative is infinite at
  # zero rotation, where forward-mode AD evaluates it (state_diff of a
  # state with itself): take the ratio's limit 2 / cos_half there.
  s2 = torch.sum(qd[..., 1:4] * qd[..., 1:4], dim=-1, keepdim=True)
  cos_half = qd[..., 0:1]
  small = s2 < 1e-12
  sin_half = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
  ratio = torch.where(small, 2.0 / torch.clamp(cos_half, min=0.5),
                      2.0 * torch.atan2(sin_half, cos_half) / sin_half)
  return qd[..., 1:4] * ratio


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors: v x m (mju_crossMotion)."""
  va, vl = v[..., :3], v[..., 3:]
  ma, ml = m[..., :3], m[..., 3:]
  return torch.cat([cross(va, ma), cross(va, ml) + cross(vl, ma)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial cross product motion x* force (mju_crossForce)."""
  va, vl = v[..., :3], v[..., 3:]
  ft, ff = f[..., :3], f[..., 3:]
  return torch.cat([cross(va, ft) + cross(vl, ff), cross(va, ff)], dim=-1)


def inert_mul(inert: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  """c-frame spatial inertia times a motion vector -> force vector.

  `inert` is packed as MuJoCo cinert: [I00 I11 I22 I01 I02 I12, h0 h1 h2,
  mass], I the rotational inertia about the reference point and
  h = mass * (com - reference point). Force = [I w + h x v, m v - h x w].
  """
  w, v = m[..., :3], m[..., 3:]
  i00, i11, i22 = inert[..., 0], inert[..., 1], inert[..., 2]
  i01, i02, i12 = inert[..., 3], inert[..., 4], inert[..., 5]
  h = inert[..., 6:9]
  mass = inert[..., 9:10]
  iw = torch.stack([
      i00 * w[..., 0] + i01 * w[..., 1] + i02 * w[..., 2],
      i01 * w[..., 0] + i11 * w[..., 1] + i12 * w[..., 2],
      i02 * w[..., 0] + i12 * w[..., 1] + i22 * w[..., 2],
  ], dim=-1)
  torque = iw + cross(h, v)
  force = mass * v - cross(h, w)
  return torch.cat([torque, force], dim=-1)


def transform_inertia(mass: torch.Tensor, diag_inertia: torch.Tensor,
                      quat: torch.Tensor, offset: torch.Tensor
                      ) -> torch.Tensor:
  """Packed c-frame spatial inertia (..., 10) about the reference point.

  mass (...,), diag_inertia (..., 3) principal moments about the body com,
  quat world-from-inertial-frame, offset = com - reference point.
  """
  r = quat_to_mat(quat)
  ic = (r * diag_inertia[..., None, :]) @ r.transpose(-1, -2)
  d = offset
  d2 = torch.sum(d * d, dim=-1)[..., None, None]
  eye = torch.eye(3, dtype=ic.dtype, device=ic.device)
  shift = mass[..., None, None] * (
      d2 * eye - d[..., :, None] * d[..., None, :])
  i_ref = ic + shift
  h = mass[..., None] * d
  return torch.cat([
      torch.stack([i_ref[..., 0, 0], i_ref[..., 1, 1], i_ref[..., 2, 2],
                   i_ref[..., 0, 1], i_ref[..., 0, 2], i_ref[..., 1, 2]],
                  dim=-1),
      h, mass[..., None]], dim=-1)


def closest_segment_point(a: torch.Tensor, b: torch.Tensor,
                          p: torch.Tensor) -> torch.Tensor:
  """Closest point to p on segment [a, b]."""
  ab = b - a
  denom = torch.clamp(torch.sum(ab * ab, dim=-1, keepdim=True), min=1e-12)
  t = torch.clamp(torch.sum((p - a) * ab, dim=-1, keepdim=True) / denom,
                  0.0, 1.0)
  return a + t * ab


def closest_segment_segment(a0: torch.Tensor, a1: torch.Tensor,
                            b0: torch.Tensor, b1: torch.Tensor):
  """Closest points between segments [a0, a1] and [b0, b1]: the clamped
  parameter of each segment, then the first re-clamped against the
  second's (approximate where both clamp)."""
  da = a1 - a0
  db = b1 - b0
  r = a0 - b0
  aa = torch.sum(da * da, dim=-1)
  bb = torch.sum(db * db, dim=-1)
  ab = torch.sum(da * db, dim=-1)
  ar = torch.sum(da * r, dim=-1)
  br = torch.sum(db * r, dim=-1)
  denom = torch.clamp(aa * bb - ab * ab, min=1e-12)
  t = torch.clamp((ab * br - bb * ar) / denom, 0.0, 1.0)
  u = torch.clamp((ab * t + br) / torch.clamp(bb, min=1e-12), 0.0, 1.0)
  t = torch.clamp((ab * u - ar) / torch.clamp(aa, min=1e-12), 0.0, 1.0)
  return a0 + t[..., None] * da, b0 + u[..., None] * db
