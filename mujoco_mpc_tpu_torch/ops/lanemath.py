"""Component-tuple math in the candidates-last layout.

Every scalar field of the physics state is a (..., K) tensor with the K
candidates on the last axis. Vectors and quaternions are python tuples
of such tensors and all algebra is written component-wise. This is the
plain PyTorch counterpart of the device functions in ops/csrc/lane_math.cuh
and backs the plain version of the rollout kernel (ops/step_lane.py).
"""

from __future__ import annotations

import torch

Vec3 = tuple  # (x, y, z) of (..., K) tensors
Quat = tuple  # (w, x, y, z)


def v3(x, y, z) -> Vec3:
  return (x, y, z)


def vadd(a: Vec3, b: Vec3) -> Vec3:
  return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a: Vec3, b: Vec3) -> Vec3:
  return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a: Vec3, s) -> Vec3:
  return (a[0] * s, a[1] * s, a[2] * s)


def vdot(a: Vec3, b: Vec3):
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a: Vec3, b: Vec3) -> Vec3:
  return (a[1] * b[2] - a[2] * b[1],
          a[2] * b[0] - a[0] * b[2],
          a[0] * b[1] - a[1] * b[0])


def qmul(u: Quat, v: Quat) -> Quat:
  w1, x1, y1, z1 = u
  w2, x2, y2, z2 = v
  return (w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
          w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
          w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
          w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2)


def qrot(q: Quat, v: Vec3) -> Vec3:
  """Rotate v by q (local -> world): v + 2 w (u x v) + 2 u x (u x v)."""
  w = q[0]
  u = (q[1], q[2], q[3])
  uv = vcross(u, v)
  t = vadd(vscale(uv, w), vcross(u, uv))
  return vadd(v, vscale(t, 2.0))


def axis_angle_quat(axis: Vec3, angle) -> Quat:
  half = 0.5 * angle
  s = torch.sin(half)
  return (torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s)


def quat_sub_tangent(qa: Quat, qb: Quat) -> Vec3:
  """3D tangent difference of component-form quaternions: the velocity v
  with qb * exp(v/2) = qa (mju_subQuat semantics, matching
  physics.math.quat_sub). qa / qb are 4-tuples of (..., K) tensors or
  scalars (broadcast-compatible)."""
  aw, ax, ay, az = qa
  bw, bx, by, bz = qb
  # qd = conj(qb) * qa
  w = bw * aw + bx * ax + by * ay + bz * az
  x = bw * ax - bx * aw - by * az + bz * ay
  y = bw * ay + bx * az - by * aw - bz * ax
  z = bw * az - bx * ay + by * ax - bz * aw
  inv = torch.rsqrt(torch.clamp(w * w + x * x + y * y + z * z, min=1e-24))
  sign = torch.where(w < 0, -inv, inv)      # shortest arc, unit norm
  w, x, y, z = w * sign, x * sign, y * sign, z * sign
  sin_half = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=0.0))
  angle = 2.0 * torch.atan2(sin_half, w)
  s = angle / torch.clamp(sin_half, min=1e-12)
  return (x * s, y * s, z * s)


def const_vec3(v, like) -> Vec3:
  """Broadcast a static length-3 vector to the layout of `like`."""
  return (torch.full_like(like, float(v[0])),
          torch.full_like(like, float(v[1])),
          torch.full_like(like, float(v[2])))


def const_quat(q, like) -> Quat:
  return tuple(torch.full_like(like, float(q[i])) for i in range(4))


def chol_solve_packed(a, b, eps=1e-10):
  """Solve A x = b for symmetric positive definite A, batch on the last
  axis. a: (n, n, K); b: (n, K). Returns x: (n, K).

  Column-at-a-time Cholesky; the diagonal is clamped at `eps` before the
  square root, so a numerically indefinite matrix yields a finite (wrong)
  answer instead of NaN. Only entries at or below the diagonal are read.
  """
  n = b.shape[0]
  cols = []   # cols[j][i] = L[i, j] for i >= j (entries above: unused)
  diag = []
  for j in range(n):
    s = a[:, j]
    for k in range(j):
      s = s - cols[k] * cols[k][j][None, :]
    d = torch.sqrt(torch.clamp(s[j], min=eps))
    cols.append(s / d[None, :])
    diag.append(d)
  y = [None] * n
  for i in range(n):
    s = b[i]
    for k in range(i):
      s = s - cols[k][i] * y[k]
    y[i] = s / diag[i]
  x = [None] * n
  for i in range(n - 1, -1, -1):
    s = y[i]
    for k in range(i + 1, n):
      s = s - cols[i][k] * x[k]
    x[i] = s / diag[i]
  return torch.stack(x)
