"""Lane-parallel rollout kernel: K candidate rollouts in one launch.

Replaces the TPU kernel `mujoco_mpc_tpu/ops/step_lane.py:
build_rollout_kernel` (Pallas). The ENTIRE rollout — FK, composite-inertia
mass matrix, RNE bias, passive forces, actuation, the in-kernel task
residual, joint-limit and ground-contact constraint rows, the Newton
constraint solve with its safeguarded line search, implicit-damping Euler —
runs for every horizon step inside one CUDA kernel, a team of lanes per
candidate (ops/csrc/lane_rollout.cu). Device memory sees only the initial
state, the spline nodes, the aux rows and the requested output (recorded
states, residual rows, or per-term cost sums).

What bounds it on an H100: latency, not bytes or arithmetic throughput.
One launch reads and writes a few megabytes but runs a long dependent
program per candidate. The design splits that program over a team of
`team_size(nv, contacts)` lanes inside one warp (per body, per joint, per
mass-matrix and Hessian entry, per contact and per row, and the Cholesky
factorisations), culls every contact and limit row whose gap is >= 0 before
the rows are built (exactly: such rows add zeros), keeps each candidate's
working set and the model's tables in shared memory (the tables staged by
Hopper's bulk asynchronous copy), and specialises the one generic source
per model with compile-time dimensions. Candidates stay on the last
(contiguous) axis of every array in device memory (PERF.md has the
measurements).

Beside the kernel stands its plain PyTorch version: the same step on
(dim, K) tensors, a direct reading of the reference `step_body`, with
python loops over the static model structure. It backs `.step_array`,
`.residual_array`, every CPU test and the on-card comparison. The wrapper
uses it only for tensors that live on the CPU; for CUDA tensors it
launches the kernel or raises.

Model class: hinge/slide/free joints, joint and site transmissions, joint
limits, the inertia-box fluid model (viscosity / density / wind),
world-static plane vs sphere / capsule / box contacts (a contact point per
sphere centre, capsule end and box corner; pyramidal rows, condim-1 rows,
or elliptic cone blocks at condim 3/4/6 with impratio), and, opted in with
`body_pairs=True`, sphere / capsule / box body-body pairs (a contact point
per sphere or segment pair, capsule end in a box or box corner in the other
box, its frame built per candidate from the normal, both bodies'
Jacobians), task residuals with static and per-step aux rows. Ball joints,
equality constraints, friction loss and activation states are outside the
rollout kernel's class, as in the JAX package
(`mujoco_mpc_tpu/ops/step_lane.py` supports): `supports` returns False for
them and `build_rollout_kernel` raises.

Two control modes: the zero-order-hold spline of the sampling planners, and
the feedback law of iLQG's line searches (`feedback=True`),
u = clip(u_nom[t] + alpha k[t] + scale K[t] dx, lo, hi) with dx the tangent
difference between the candidate's state and the nominal one, alpha and
scale per candidate, and the per-step table (u_nom, k, K, x_nom) shared by
all candidates and read from global memory.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch.costs.norms import NormType
from mujoco_mpc_tpu_torch.ops import _build
from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.physics import kinematics
from mujoco_mpc_tpu_torch.physics.model import (
    BIAS_NONE, FREE, GAIN_FIXED, GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE,
    GEOM_SPHERE, HINGE, SLIDE, TRN_JOINT, TRN_SITE, Model, fluid_box,
    make_data)

# launches of the CUDA kernel made by any rollout wrapper of this module
# (incremented where a wrapper launches, nowhere else)
launch_count = 0

MODE_STATES, MODE_RESIDUALS, MODE_COST_SUMS = 0, 1, 2


def _np(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def _ground_groups(m: Model):
  """Plane-vs-{sphere,capsule,box} pair groups whose plane is
  world-static; ground pairs of other geom types (e.g. cylinders) are
  dropped from the planning model, as in the JAX package."""
  if m.collision_pairs is None:
    return []
  out = []
  for g in m.collision_pairs.groups:
    if g.types[0] != GEOM_PLANE:
      continue
    if g.types[1] not in (GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX):
      continue
    if any(int(m.geom_bodyid[gid]) != 0 for gid in g.geom1):
      continue
    out.append(g)
  return out


def _selected_ground_pairs(m: Model, contact_types, contact_geoms):
  """(group, pair index) of every ground pair the planning model keeps."""
  out = []
  for g in _ground_groups(m):
    if contact_types is not None and g.types[1] not in contact_types:
      continue
    for pi in range(g.count):
      if contact_geoms is not None and int(g.geom2[pi]) not in contact_geoms:
        continue
      out.append((g, pi))
  return out


# body-body pair types the kernel handles (geom types of geom1, geom2)
_BODY_TYPES = frozenset({
    (GEOM_SPHERE, GEOM_SPHERE), (GEOM_SPHERE, GEOM_CAPSULE),
    (GEOM_CAPSULE, GEOM_CAPSULE), (GEOM_SPHERE, GEOM_BOX),
    (GEOM_CAPSULE, GEOM_BOX), (GEOM_BOX, GEOM_BOX)})


def _selected_body_pairs(m: Model, body_pair_types, contact_geoms):
  """(group, pair index) of every body-body pair the planning model keeps,
  in the JAX kernel's order: the pair types of `body_pair_types` (default:
  all six), both geoms in `contact_geoms` (if given), ground pairs
  excluded."""
  cp = m.collision_pairs
  if cp is None:
    return []
  allowed = _BODY_TYPES if body_pair_types is None \
      else frozenset(tuple(int(v) for v in t) for t in body_pair_types)
  ground = {(int(a), int(b)) for g in _ground_groups(m)
            for a, b in zip(g.geom1, g.geom2)}
  out = []
  for g in cp.groups:
    types = tuple(int(t) for t in g.types)
    if types not in _BODY_TYPES or types not in allowed:
      continue
    for pi in range(g.count):
      g1, g2 = int(g.geom1[pi]), int(g.geom2[pi])
      if (g1, g2) in ground:
        continue
      if contact_geoms is not None and not (
          g1 in contact_geoms and g2 in contact_geoms):
        continue
      out.append((g, pi))
  return out


def unsupported(m: Model, ground_only: bool = False,
                body_pairs: bool = False) -> Optional[str]:
  """What puts `m` outside the kernel's model class, or None; answers what
  the JAX package's supports(m, ground_only, body_pairs) answers. With
  ground_only=True, candidate pairs outside the kernel's contact class are
  DROPPED from the planning dynamics (a deliberate planning-model
  approximation, the JAX package's own): every body-body pair with
  body_pairs=False, body-body pairs of other geom types with
  body_pairs=True."""
  jt = set(int(t) for t in m.jnt_type)
  if not jt <= {HINGE, SLIDE, FREE}:
    return "ball joints"
  if m.collision_pairs is not None and m.collision_pairs.ncon > 0:
    if not ground_only:
      return "body-body contact pairs (pass ground_only=True to drop them)"
    if not _ground_groups(m) and not body_pairs:
      return ("body-body contact pairs (the model has no ground pairs; pass "
              "body_pairs=True to keep them)")
  if m.neq:
    return "equality constraints"
  if m.na:
    return "activation states"
  if np.any(_np(m.dof_frictionloss) > 0):
    return "friction loss"
  for u in range(m.nu):
    if int(m.actuator_trntype[u]) not in (TRN_JOINT, TRN_SITE):
      return f"actuator transmission type {int(m.actuator_trntype[u])}"
  return None


def supports(m: Model, ground_only: bool = False,
             body_pairs: bool = False) -> bool:
  """Model class the kernel handles (`unsupported` says what is missing)."""
  return unsupported(m, ground_only, body_pairs) is None


def _static(m: Model) -> dict:
  """Pull all model constants to host numpy."""
  g = _np
  return dict(
      body_pos=g(m.body_pos), body_quat=g(m.body_quat),
      body_ipos=g(m.body_ipos), body_iquat=g(m.body_iquat),
      body_mass=g(m.body_mass), body_inertia=g(m.body_inertia),
      body_subtreemass=g(m.body_subtreemass),
      jnt_pos=g(m.jnt_pos), jnt_axis=g(m.jnt_axis),
      jnt_stiffness=g(m.jnt_stiffness), qpos0=g(m.qpos0),
      qpos_spring=g(m.qpos_spring), dof_damping=g(m.dof_damping),
      dof_armature=g(m.dof_armature),
      gainprm=g(m.actuator_gainprm), biasprm=g(m.actuator_biasprm),
      gaintype=g(m.actuator_gaintype), biastype=g(m.actuator_biastype),
      ctrlrange=g(m.actuator_ctrlrange),
      ctrllimited=g(m.actuator_ctrllimited),
      gear=g(m.actuator_gear), gravity=g(m.opt.gravity),
      timestep=float(g(m.opt.timestep)),
      jnt_range=g(m.jnt_range), jnt_solref=g(m.jnt_solref),
      jnt_solimp=g(m.jnt_solimp), jnt_margin=g(m.jnt_margin),
      dof_invweight0=g(m.dof_invweight0),
      geom_pos=g(m.geom_pos), geom_quat=g(m.geom_quat),
      geom_size=g(m.geom_size), body_invweight0=g(m.body_invweight0),
      forcerange=g(m.actuator_forcerange),
      forcelimited=g(m.actuator_forcelimited),
      site_pos=g(m.site_pos), site_quat=g(m.site_quat),
      impratio=float(g(m.opt.impratio)),
      cone=int(m.opt.cone),
      viscosity=float(g(m.opt.viscosity)), density=float(g(m.opt.density)),
      wind=g(m.opt.wind),
  )


def lane_term_cost(rows, ntype, p, q):
  """Unweighted norm value of a residual slice in lane layout.

  rows: list of (K,) component tensors; p, q: norm-parameter tensors
  broadcastable to the rows. Mirrors costs/norms.py::norm_value term by
  term so the in-kernel score matches the cost path up to reassociation.
  """
  eps = 1e-15
  nt = NormType(ntype)
  if nt == NormType.NULL:
    return rows[0]
  if nt == NormType.QUADRATIC:
    return 0.5 * sum(r * r for r in rows)
  if nt == NormType.L22:
    c = torch.clamp(sum(r * r for r in rows), min=eps)
    a = torch.pow(c, q / 2) + torch.pow(p, q)
    return torch.pow(a, 1.0 / q) - p
  if nt == NormType.L2:
    return torch.sqrt(sum(r * r for r in rows) + p * p) - p
  if nt == NormType.COSH:
    return sum(p * p * (torch.cosh(r / p) - 1.0) for r in rows)
  if nt == NormType.POWER_LOSS:
    return sum(torch.pow(torch.abs(r), p) for r in rows)
  if nt == NormType.SMOOTH_ABS:
    return sum(torch.sqrt(r * r + p * p) - p for r in rows)
  if nt == NormType.SMOOTH_ABS2:
    return sum(torch.pow(torch.pow(torch.abs(r), q) + torch.pow(p, q),
                         1.0 / q) - p for r in rows)
  if nt == NormType.RECTIFY:
    return sum(torch.where(
        p > 0, p * torch.log1p(torch.exp(r / torch.clamp(p, min=eps))),
        torch.clamp(r, min=0.0)) for r in rows)
  raise ValueError(f"unknown norm {ntype}")


def _impedance_consts(solref, solimp) -> np.ndarray:
  """Static part of the constraint impedance / reference acceleration:
  [d0, dmax, width, mid, power, a_c, b_c, b_coef, k_coef]."""
  d0 = float(np.clip(solimp[0], 1e-4, 0.9999))
  dmax = float(np.clip(solimp[1], 1e-4, 0.9999))
  width = max(float(solimp[2]), 1e-12)
  mid = float(np.clip(solimp[3], 1e-4, 0.9999))
  power = max(float(solimp[4]), 1.0)
  a_c = 1.0 / mid ** (power - 1.0)
  b_c = 1.0 / (1.0 - mid) ** (power - 1.0)
  tc, dr = float(solref[0]), float(solref[1])
  b_coef = 2.0 / max(dmax * tc, 1e-12)
  k_coef = 1.0 / max(dmax * dmax * tc * tc * dr * dr, 1e-12)
  return np.array([d0, dmax, width, mid, power, a_c, b_c, b_coef, k_coef],
                  np.float64)


def _quat_rotate(q, v) -> np.ndarray:
  w, x, y, z = [float(t) for t in q]
  r = np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
  return r @ np.asarray(v, dtype=np.float64)


def _geom_points(m: Model, c: dict, gid: int) -> list:
  """(body-local point, radius) of every contact point a ground geom
  carries, in the JAX kernel's order: a sphere's centre; a capsule's two
  end centres at +-half-length along the geom z axis; a box's 8 corners
  (radius 0). Host float64: geom_pos + R(geom_quat) local."""
  gtype = int(m.geom_type[gid])
  size = np.asarray(c["geom_size"][gid], np.float64)
  gpos = np.asarray(c["geom_pos"][gid], np.float64)
  gquat = c["geom_quat"][gid]
  if gtype == GEOM_SPHERE:
    return [(gpos, float(size[0]))]
  if gtype == GEOM_CAPSULE:
    return [(gpos + _quat_rotate(gquat, [0.0, 0.0, sgn * size[1]]),
             float(size[0])) for sgn in (1.0, -1.0)]
  if gtype == GEOM_BOX:
    return [(gpos + _quat_rotate(gquat, [sx * size[0], sy * size[1],
                                         sz * size[2]]), 0.0)
            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
  raise NotImplementedError(f"ground contact of geom type {gtype}")


def _pair_offsets(cp) -> dict:
  """(geom1, geom2) -> offset of the pair's row in the per-contact solver
  parameters (con_friction, con_solref, ...)."""
  meta = {}
  off = 0
  for g in cp.groups:
    for pi in range(g.count):
      meta[(int(g.geom1[pi]), int(g.geom2[pi]))] = off
      off += g.ncon_per_pair
  return meta


def _pair_solver(m: Model, c: dict, ci: int, b1: int, b2: int) -> dict:
  """The mixed solver parameters of the pair at offset `ci` between bodies
  b1 and b2 (the world is body 0), its supporting dofs (either body's, in
  dof order), and the constants its rows derive from them."""
  cp = m.collision_pairs
  fri = np.asarray(cp.con_friction[ci], np.float64)
  invw = float(c["body_invweight0"][b1][0] + c["body_invweight0"][b2][0])
  mu0 = max(float(fri[0]), 1e-12)
  impr = max(c["impratio"], 1e-12)
  mask = m.body_dof_mask
  return dict(
      fri=fri, imp=_impedance_consts(cp.con_solref[ci], cp.con_solimp[ci]),
      incm=float(cp.con_includemargin[ci]), invw=invw,
      condim=int(cp.con_condim[ci]),
      support=[i for i in range(m.nv) if mask[b1][i] > 0 or mask[b2][i] > 0],
      # elliptic: mu_eff = mu0 / sqrt(impratio), scales mu_i / mu_eff
      mu=mu0 / np.sqrt(impr),
      scales=fri / (mu0 / np.sqrt(impr)),
      # pyramidal: friction[0]-based diagonal stiffened by impratio
      iw=invw * 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) / impr)


def _contact_plan(m: Model, c: dict, contact_types, contact_geoms) -> list:
  """Static description of every ground contact POINT the planning model
  keeps (a sphere centre, a capsule end or a box corner): body and geom,
  body-local point and radius, the static plane and contact frame, the
  pair's mixed solver parameters (a capsule's two ends share its pair's),
  supporting dofs."""
  cp = m.collision_pairs
  if cp is None or cp.ncon == 0:
    return []
  meta = _pair_offsets(cp)
  out = []
  for g, pi in _selected_ground_pairs(m, contact_types, contact_geoms):
    g1, g2 = int(g.geom1[pi]), int(g.geom2[pi])
    bid = int(m.geom_bodyid[g2])
    n_pl = _quat_rotate(c["geom_quat"][g1], [0, 0, 1.0])
    p_pl = np.asarray(c["geom_pos"][g1], dtype=np.float64)
    # static normal -> static tangents
    refv = np.array([1.0, 0, 0]) if abs(n_pl[0]) < 0.5 \
        else np.array([0, 1.0, 0])
    t1 = np.cross(n_pl, refv)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n_pl, t1)
    pair = dict(_pair_solver(m, c, meta[(g1, g2)], 0, bid), bid=bid,
                geom=g2, n_pl=n_pl, p_pl=p_pl, dirs=[n_pl, t1, t2])
    for point, radius in _geom_points(m, c, g2):
      out.append(dict(pair, geom_pos=point, radius=radius))
  return out


# kinds of body contact point entries
BODY_SEG, BODY_BOX = 0, 1


def _body_plan(m: Model, c: dict, body_pair_types, contact_geoms) -> list:
  """Static description of every body-body contact POINT the planning model
  keeps, in the JAX kernel's order (pair, capsule end +/-, box-box source
  box, corner): sphere-sphere, sphere-capsule and capsule-capsule pairs are
  one segment entry each (BODY_SEG: two body-local segments, a sphere's of
  half-length 0, their closest points by the JAX kernel's three clamps);
  sphere-box, capsule-box (one entry per capsule end) and box-box (all 8
  corners of either box in the other) are point-in-box entries (BODY_BOX: a
  body-local point and radius against a body-local box, `flip` when the
  point is geom2's). Each carries its pair's bodies b1 -> b2 (the normal
  points from geom1 to geom2), solver parameters and the union support of
  both bodies' dofs. Body-local points and axes are composed on the host in
  float64."""
  cp = m.collision_pairs
  pairs = _selected_body_pairs(m, body_pair_types, contact_geoms)
  if not pairs:
    return []
  meta = _pair_offsets(cp)
  ez = [0.0, 0.0, 1.0]

  def local(gid, v):
    return np.asarray(c["geom_pos"][gid], np.float64) + \
        _quat_rotate(c["geom_quat"][gid], v)

  def size(gid):
    return np.asarray(c["geom_size"][gid], np.float64)

  def seg(gid):
    """(body, centre, axis, half-length, radius) of a sphere or capsule."""
    half = size(gid)[1] if int(m.geom_type[gid]) == GEOM_CAPSULE else 0.0
    return (int(m.geom_bodyid[gid]), local(gid, [0.0, 0.0, 0.0]),
            _quat_rotate(c["geom_quat"][gid], ez), float(half),
            float(size(gid)[0]))

  def box(gid):
    """(body, centre, geom quaternion in the body, half-sizes)."""
    return (int(m.geom_bodyid[gid]), local(gid, [0.0, 0.0, 0.0]),
            np.asarray(c["geom_quat"][gid], np.float64), size(gid)[:3])

  out = []
  # the fields of the other kind stay zero (one table layout for both)
  unused = dict(ua=np.zeros(3), ub=np.zeros(3), ha=0.0, hb=0.0, rb=0.0,
                qb=np.zeros(4), sb=np.zeros(3), flip=False)
  for g, pi in pairs:
    g1, g2 = int(g.geom1[pi]), int(g.geom2[pi])
    b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
    pair = dict(_pair_solver(m, c, meta[(g1, g2)], b1, b2), **unused, b1=b1,
                b2=b2, types=tuple(int(t) for t in g.types), geoms=(g1, g2))
    t1, t2 = pair["types"]
    if t2 != GEOM_BOX:
      ba, pa, ua, ha, ra = seg(g1)
      bb, pb, ub, hb, rb = seg(g2)
      out.append(dict(pair, kind=BODY_SEG, ba=ba, pa=pa, ua=ua, ha=ha,
                      ra=ra, bb=bb, pb=pb, ub=ub, hb=hb, rb=rb))
      continue
    if t1 == GEOM_BOX:
      # vertex-in-box both ways: every corner of one box against the other
      points = []
      for src, dst, flip in ((g1, g2, False), (g2, g1, True)):
        s = size(src)
        points += [(src, dst, flip, local(src, [sx * s[0], sy * s[1],
                                                sz * s[2]]), 0.0)
                   for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    elif t1 == GEOM_CAPSULE:
      s = size(g1)
      points = [(g1, g2, False, local(g1, [0.0, 0.0, sgn * s[1]]),
                 float(s[0])) for sgn in (1.0, -1.0)]
    else:
      points = [(g1, g2, False, local(g1, [0.0, 0.0, 0.0]),
                 float(size(g1)[0]))]
    for src, dst, flip, point, radius in points:
      bb, pb, qb, sb = box(dst)
      out.append(dict(pair, kind=BODY_BOX, ba=int(m.geom_bodyid[src]),
                      pa=point, ra=radius, bb=bb, pb=pb, qb=qb, sb=sb,
                      flip=flip))
  return out


def contact_clearance(m: Model, qpos) -> float:
  """Lowest clearance (distance along the plane normal less the radius) of
  the ground contact points the kernel keeps, at one configuration qpos
  (nq,)."""
  qpos = torch.as_tensor(qpos, dtype=m.qpos0.dtype, device=m.qpos0.device)
  d = kinematics.kinematics(m, make_data(m).replace(qpos=qpos))
  xpos, xquat = _np(d.xpos), _np(d.xquat)
  return min(
      float((xpos[con["bid"]] + _quat_rotate(xquat[con["bid"]],
                                             con["geom_pos"])
             - con["p_pl"]) @ con["n_pl"]) - con["radius"]
      for con in _contact_plan(m, _static(m), None, None))


def contact_gaps(m: Model, qpos, contact_geoms=None, body_pairs=False,
                 body_pair_types=None) -> list:
  """(geom types of the pair, condim, gap (K,)) of every contact point the
  kernel keeps at configurations qpos (nq, K), in the tables' order (the
  ground points, then the body points). The gap is the distance less the
  pair's included margin: a point's rows enter the solve where it is
  negative."""
  c = _static(m)
  qpos = torch.as_tensor(qpos, dtype=m.qpos0.dtype, device=m.qpos0.device)
  d0 = make_data(m)

  def frames(q):
    d = kinematics.kinematics(m, d0.replace(qpos=q))
    return d.xpos, d.xquat

  xp, xq = torch.func.vmap(frames)(qpos.T)
  xpos = [tuple(xp[:, b, i] for i in range(3)) for b in range(m.nbody)]
  xquat = [tuple(xq[:, b, i] for i in range(4)) for b in range(m.nbody)]

  def cv(v):
    return lm.const_vec3(v, qpos[0])

  out = []
  for con in _contact_plan(m, c, None, contact_geoms):
    bid = con["bid"]
    gpos = lm.vadd(xpos[bid], lm.qrot(xquat[bid], cv(con["geom_pos"])))
    dist = lm.vdot(lm.vsub(gpos, cv(con["p_pl"])), cv(con["n_pl"])) \
        - con["radius"]
    out.append(((GEOM_PLANE, int(m.geom_type[con["geom"]])), con["condim"],
                dist - con["incm"]))
  for bc in (_body_plan(m, c, body_pair_types, contact_geoms)
             if body_pairs else []):
    _, dist, _ = body_contact_point(bc, xpos, xquat, cv)
    out.append((bc["types"], bc["condim"], dist - bc["incm"]))
  return out


def _limit_plan(m: Model, c: dict) -> list:
  out = []
  for j in range(m.njnt):
    if not m.jnt_limited[j]:
      continue
    out.append(dict(
        jnt=j, qadr=int(m.jnt_qposadr[j]), dadr=int(m.jnt_dofadr[j]),
        lo=float(c["jnt_range"][j][0]), hi=float(c["jnt_range"][j][1]),
        margin=float(c["jnt_margin"][j]),
        imp=_impedance_consts(c["jnt_solref"][j], c["jnt_solimp"][j]),
        invw=float(c["dof_invweight0"][int(m.jnt_dofadr[j])])))
  return out


def _fluid_plan(m: Model, c: dict) -> list:
  """Per body with mass, the inertia-box fluid coefficients (viscous
  torque / force, quadratic-drag force / torque per local axis); empty when
  the medium has no viscosity, density or wind."""
  visc, rho = c["viscosity"], c["density"]
  if not (visc > 0.0 or rho > 0.0 or np.any(c["wind"] != 0.0)):
    return []
  box = fluid_box(c["body_mass"], c["body_inertia"])
  out = []
  for i in range(1, m.nbody):
    if float(c["body_mass"][i]) <= 1e-12:
      continue
    b0, b1, b2 = (float(v) for v in box[i])
    diam = (b0 + b1 + b2) / 3.0
    out.append(dict(
        body=i, visc_t=np.pi * diam ** 3 * visc,
        visc_f=3.0 * np.pi * diam * visc,
        dens_f=[0.5 * rho * b1 * b2, 0.5 * rho * b0 * b2,
                0.5 * rho * b0 * b1],
        dens_t=[rho * b0 * (b1 ** 4 + b2 ** 4) / 64.0,
                rho * b1 * (b0 ** 4 + b2 ** 4) / 64.0,
                rho * b2 * (b0 ** 4 + b1 ** 4) / 64.0],
        dofs=[d for d in range(m.nv) if m.body_dof_mask[i][d] > 0]))
  return out


def _vnorm(v):
  return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + 1e-18)


def _vnormalize(v):
  n_ = _vnorm(v)
  return (v[0] / n_, v[1] / n_, v[2] / n_), n_


def body_contact_point(bc: dict, xpos, xquat, cv):
  """(contact point, distance, normal from geom1 to geom2) of one body
  contact entry of `_body_plan`, per candidate (component lists)."""
  ba, bb = bc["ba"], bc["bb"]
  ca = lm.vadd(xpos[ba], lm.qrot(xquat[ba], cv(bc["pa"])))
  if bc["kind"] == BODY_SEG:
    # closest points of the two segments: the JAX kernel's three clamps
    cb = lm.vadd(xpos[bb], lm.qrot(xquat[bb], cv(bc["pb"])))
    ax1 = lm.qrot(xquat[ba], cv(bc["ua"]))
    ax2 = lm.qrot(xquat[bb], cv(bc["ub"]))
    h1, h2 = bc["ha"], bc["hb"]
    r_ = lm.vsub(cb, ca)
    a_d = lm.vdot(ax1, ax2)
    s1d = lm.vdot(ax1, r_)
    s2d = lm.vdot(ax2, r_)
    den = torch.clamp(1.0 - a_d * a_d, min=1e-9)
    t1s = torch.clamp((s1d - a_d * s2d) / den, -h1, h1)
    t2s = torch.clamp(a_d * t1s - s2d, -h2, h2)
    t1s = torch.clamp(a_d * t2s + s1d, -h1, h1)
    pa = lm.vadd(ca, lm.vscale(ax1, t1s))
    pb = lm.vadd(cb, lm.vscale(ax2, t2s))
    n_, dn = _vnormalize(lm.vsub(pb, pa))
    dist = dn - bc["ra"] - bc["rb"]
    return lm.vadd(pa, lm.vscale(n_, bc["ra"] + 0.5 * dist)), dist, n_
  # a point of radius ra (sphere centre, capsule end, box corner) against a
  # box: outside, the closest point of the box; inside, the nearest face
  b_pos = lm.vadd(xpos[bb], lm.qrot(xquat[bb], cv(bc["pb"])))
  b_quat = lm.qmul(xquat[bb], lm.const_quat(bc["qb"], xpos[bb][0]))
  loc = lm.qrot((b_quat[0], -b_quat[1], -b_quat[2], -b_quat[3]),
                lm.vsub(ca, b_pos))
  sz = [float(v) for v in bc["sb"]]
  cl = tuple(torch.clamp(loc[k], -sz[k], sz[k]) for k in range(3))
  dvec = lm.vsub(loc, cl)
  dn = _vnorm(dvec)
  outside = dn > 1e-9
  n_out = (dvec[0] / dn, dvec[1] / dn, dvec[2] / dn)
  fd = [sz[k] - torch.abs(loc[k]) for k in range(3)]
  m01 = fd[0] < fd[1]
  m02 = torch.minimum(fd[0], fd[1]) < fd[2]
  one = torch.ones_like(dn)
  sgn = [torch.where(loc[k] >= 0, one, -one) for k in range(3)]
  zero = torch.zeros_like(dn)
  n_in = (torch.where(m01 & m02, sgn[0], zero),
          torch.where((~m01) & m02, sgn[1], zero),
          torch.where(~m02, sgn[2], zero))
  depth = torch.where(m02, torch.where(m01, fd[0], fd[1]), fd[2])
  n_loc = tuple(torch.where(outside, n_out[k], n_in[k]) for k in range(3))
  dist_l = torch.where(outside, dn, -depth)
  cp_loc = tuple(torch.where(outside, cl[k],
                             torch.where(n_in[k] != 0, sgn[k] * sz[k],
                                         loc[k])) for k in range(3))
  n_w = lm.qrot(b_quat, n_loc)     # from the box toward the point
  cp_w = lm.vadd(b_pos, lm.qrot(b_quat, cp_loc))
  dist = dist_l - bc["ra"]
  pt = lm.vadd(cp_w, lm.vscale(n_w, 0.5 * dist))
  if bc["flip"]:
    return pt, dist, n_w
  return pt, dist, (-n_w[0], -n_w[1], -n_w[2])


def _make_step_body(m: Model, c: dict, limits: list, contacts: list,
                    bodies: list, fluid: list, n_newton: int, n_ls: int,
                    residual_fn, residual_dim):
  """The plain PyTorch step on component lists of (K,) tensors."""
  nq, nv, nu, nb = m.nq, m.nv, m.nu, m.nbody
  h = c["timestep"]

  def impedance(pos, ic):
    d0, dmax, width, mid, power, a_c, b_c = (float(v) for v in ic[:7])
    x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
    y = torch.where(x <= mid, a_c * x ** power,
                    1.0 - b_c * (1.0 - x) ** power)
    return torch.clamp(d0 + y * (dmax - d0), 1e-4, 0.9999)

  def kbi(pos, jv, ic, invw):
    imp = impedance(pos, ic)
    aref = -float(ic[7]) * jv - float(ic[8]) * imp * pos
    r_reg = torch.clamp((1.0 - imp) / imp * float(invw), min=1e-12)
    dcoef = torch.where(pos < 0, 1.0 / r_reg, torch.zeros_like(pos))
    return aref, dcoef

  def step_body(qpos, qvel, ctrl, t_step=None, aux=None,
                derived_only=False, aux_dyn=None):
    """One physics step; returns (qpos', qvel', res) where res is the
    residual row list (or None). `aux` holds the task's aux rows, `aux_dyn`
    reads row i of the (naux, K) aux tensor (per-step rows). With
    derived_only, only the quantities the residual needs are computed and
    (None, None, res) is returned."""
    like = qpos[0]
    skip_dyn = derived_only

    def cv(v):
      return lm.const_vec3(v, like)

    # ---- FK ----
    xpos = [cv([0, 0, 0])] * nb
    xquat = [(torch.ones_like(like), like * 0, like * 0, like * 0)] * nb
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt
    for i in range(1, nb):
      pid = int(m.body_parentid[i])
      pos = lm.vadd(xpos[pid], lm.qrot(xquat[pid], cv(c["body_pos"][i])))
      quat = lm.qmul(xquat[pid], lm.const_quat(c["body_quat"][i], like))
      ja = int(m.body_jntadr[i])
      for k in range(int(m.body_jntnum[i])):
        j = ja + k
        qadr = int(m.jnt_qposadr[j])
        anchor = lm.vadd(lm.qrot(quat, cv(c["jnt_pos"][j])), pos)
        axis = lm.qrot(quat, cv(c["jnt_axis"][j]))
        if int(m.jnt_type[j]) == FREE:
          pos = (qpos[qadr], qpos[qadr + 1], qpos[qadr + 2])
          qn = torch.sqrt(qpos[qadr + 3]**2 + qpos[qadr + 4]**2 +
                          qpos[qadr + 5]**2 + qpos[qadr + 6]**2)
          inv = 1.0 / torch.clamp(qn, min=1e-12)
          quat = (qpos[qadr + 3] * inv, qpos[qadr + 4] * inv,
                  qpos[qadr + 5] * inv, qpos[qadr + 6] * inv)
          anchor = pos
          axis = cv(c["jnt_axis"][j])  # global z, not rotated
        elif int(m.jnt_type[j]) == SLIDE:
          disp = qpos[qadr] - float(c["qpos0"][qadr])
          pos = lm.vadd(pos, lm.vscale(axis, disp))
        else:  # HINGE
          angle = qpos[qadr] - float(c["qpos0"][qadr])
          qloc = lm.axis_angle_quat(cv(c["jnt_axis"][j]), angle)
          quat = lm.qmul(quat, qloc)
          pos = lm.vsub(anchor, lm.qrot(quat, cv(c["jnt_pos"][j])))
        xanchor[j] = anchor
        xaxis[j] = axis
      xpos[i] = pos
      xquat[i] = quat

    # ---- com quantities ----
    xipos = [lm.vadd(xpos[i], lm.qrot(xquat[i], cv(c["body_ipos"][i])))
             for i in range(nb)]
    sub_sum = [lm.vscale(xipos[i], float(c["body_mass"][i]))
               for i in range(nb)]
    for i in range(nb - 1, 0, -1):
      pid = int(m.body_parentid[i])
      sub_sum[pid] = lm.vadd(sub_sum[pid], sub_sum[i])
    subtree_com = [lm.vscale(sub_sum[i],
                             1.0 / max(float(c["body_subtreemass"][i]),
                                       1e-12))
                   for i in range(nb)]
    # reference point per body: subtree com of its root
    ref = [subtree_com[int(m.body_rootid[i])] for i in range(nb)]

    # packed spatial inertia about ref (I 3x3 entries, h, mass)
    def inertia_of(i):
      quat = lm.qmul(xquat[i], lm.const_quat(c["body_iquat"][i], like))
      e0 = lm.qrot(quat, cv([1, 0, 0]))
      e1 = lm.qrot(quat, cv([0, 1, 0]))
      e2 = lm.qrot(quat, cv([0, 0, 1]))
      di = c["body_inertia"][i]
      rows = [[like * 0.0] * 3 for _ in range(3)]
      for dk, ek in zip(di, (e0, e1, e2)):
        for a in range(3):
          for b in range(3):
            rows[a][b] = rows[a][b] + float(dk) * ek[a] * ek[b]
      mass = float(c["body_mass"][i])
      d = lm.vsub(xipos[i], ref[i])
      d2 = lm.vdot(d, d)
      for a in range(3):
        rows[a][a] = rows[a][a] + mass * d2
        for b in range(3):
          rows[a][b] = rows[a][b] - mass * d[a] * d[b]
      hvec = lm.vscale(d, mass)
      return rows, hvec, mass

    cinert = None if skip_dyn else [inertia_of(i) for i in range(nb)]

    # cdof per dof
    cdof = []
    for j in range(m.njnt):
      bid = int(m.jnt_bodyid[j])
      jtype = int(m.jnt_type[j])
      if jtype == SLIDE:
        cdof.append((cv([0, 0, 0]), xaxis[j]))
      elif jtype == HINGE:
        offset = lm.vsub(ref[bid], xanchor[j])
        cdof.append((xaxis[j], lm.vcross(xaxis[j], offset)))
      else:  # FREE: world translations, then body-frame rotation axes
        for k in range(3):
          e = [0.0, 0.0, 0.0]
          e[k] = 1.0
          cdof.append((cv([0, 0, 0]), cv(e)))
        offset = lm.vsub(ref[bid], xanchor[j])
        for k in range(3):
          e = [0.0, 0.0, 0.0]
          e[k] = 1.0
          ax = lm.qrot(xquat[bid], cv(e))  # body axis k in world
          cdof.append((ax, lm.vcross(ax, offset)))

    def imul(inert, mot):
      """Spatial inertia times motion -> force (component form)."""
      rows, hvec, mass = inert
      w, v = mot
      iw = tuple(rows[a][0] * w[0] + rows[a][1] * w[1] + rows[a][2] * w[2]
                 for a in range(3))
      torque = lm.vadd(iw, lm.vcross(hvec, v))
      force = lm.vsub(lm.vscale(v, mass), lm.vcross(hvec, w))
      return (torque, force)

    # ---- CRB mass matrix ----
    crb = [] if skip_dyn else [cinert[i] for i in range(nb)]
    for i in ([] if skip_dyn else range(nb - 1, 0, -1)):
      pid = int(m.body_parentid[i])
      if pid > 0:
        r0, h0, m0 = crb[pid]
        r1, h1, m1 = crb[i]
        crb[pid] = ([[r0[a][b] + r1[a][b] for b in range(3)]
                     for a in range(3)], lm.vadd(h0, h1), m0 + m1)

    anc = m.dof_ancestor_mask
    mrows = [[like * 0.0] * nv for _ in range(nv)]
    for i in ([] if skip_dyn else range(nv)):
      f = imul(crb[int(m.dof_bodyid[i])], cdof[i])
      for j in range(nv):
        if anc[i, j] or anc[j, i]:
          val = lm.vdot(f[0], cdof[j][0]) + lm.vdot(f[1], cdof[j][1])
          if j <= i:
            mrows[i][j] = val
            mrows[j][i] = val
      mrows[i][i] = mrows[i][i] + float(c["dof_armature"][i])

    # ---- velocities + RNE bias ----
    cvel = [(cv([0, 0, 0]), cv([0, 0, 0]))] * nb
    cdof_dot = [(cv([0, 0, 0]), cv([0, 0, 0]))] * nv

    def mcross(a, b):
      return (lm.vcross(a[0], b[0]),
              lm.vadd(lm.vcross(a[0], b[1]), lm.vcross(a[1], b[0])))

    def vplus(v, n):
      return (lm.vadd(v[0], lm.vscale(cdof[n][0], qvel[n])),
              lm.vadd(v[1], lm.vscale(cdof[n][1], qvel[n])))

    for i in range(1, nb):
      pid = int(m.body_parentid[i])
      v = cvel[pid]
      da = int(m.body_dofadr[i])
      k = 0
      ndofs = int(m.body_dofnum[i])
      while k < ndofs:
        n = da + k
        jtype = int(m.jnt_type[int(m.dof_jntid[n])])
        if jtype == FREE:
          for kk in range(3):      # translations: cdof_dot = 0
            v = vplus(v, da + kk)
          vpre = v
          for kk in range(3, 6):   # rotations: pre-velocity = translations
            cdof_dot[da + kk] = mcross(vpre, cdof[da + kk])
            v = vplus(v, da + kk)
          k += 6
        else:
          cdof_dot[n] = mcross(v, cdof[n])
          v = vplus(v, n)
          k += 1
      cvel[i] = v

    grav = c["gravity"]
    cacc = [(cv([0, 0, 0]), cv([-grav[0], -grav[1], -grav[2]]))] + \
        [None] * (nb - 1)
    for i in ([] if skip_dyn else range(1, nb)):
      pid = int(m.body_parentid[i])
      a = cacc[pid]
      da = int(m.body_dofadr[i])
      for k in range(int(m.body_dofnum[i])):
        n = da + k
        a = (lm.vadd(a[0], lm.vscale(cdof_dot[n][0], qvel[n])),
             lm.vadd(a[1], lm.vscale(cdof_dot[n][1], qvel[n])))
      cacc[i] = a

    cfrc = [None] * nb
    for i in ([] if skip_dyn else range(1, nb)):
      iv = imul(cinert[i], cvel[i])
      ia = imul(cinert[i], cacc[i])
      w, v = cvel[i]
      # force cross: (w x t + v x f, w x f)
      fc = (lm.vadd(lm.vcross(w, iv[0]), lm.vcross(v, iv[1])),
            lm.vcross(w, iv[1]))
      cfrc[i] = (lm.vadd(ia[0], fc[0]), lm.vadd(ia[1], fc[1]))
    for i in ([] if skip_dyn else range(nb - 1, 0, -1)):
      pid = int(m.body_parentid[i])
      if pid > 0:
        cfrc[pid] = (lm.vadd(cfrc[pid][0], cfrc[i][0]),
                     lm.vadd(cfrc[pid][1], cfrc[i][1]))

    qfrc_bias = [like * 0.0] * nv if skip_dyn else \
        [lm.vdot(cdof[i][0], cfrc[int(m.dof_bodyid[i])][0]) +
         lm.vdot(cdof[i][1], cfrc[int(m.dof_bodyid[i])][1])
         for i in range(nv)]

    # ---- passive + actuation ----
    qfrc = [like * 0.0 for _ in range(nv)]
    for j in range(m.njnt):
      qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
      stiff = float(c["jnt_stiffness"][j])
      qfrc[dadr] = qfrc[dadr] - stiff * (
          qpos[qadr] - float(c["qpos_spring"][qadr]))
    for i in range(nv):
      qfrc[i] = qfrc[i] - float(c["dof_damping"][i]) * qvel[i]

    # fluid: viscous and quadratic drag on each body's inertia box, in the
    # body's inertial frame, applied at its com
    for fl in fluid:
      i = fl["body"]
      off = lm.vsub(xipos[i], ref[i])
      w_w, v_w = cvel[i]
      v_w = lm.vsub(lm.vadd(v_w, lm.vcross(w_w, off)), cv(c["wind"]))
      qw = lm.qmul(xquat[i], lm.const_quat(c["body_iquat"][i], like))
      qc = (qw[0], -qw[1], -qw[2], -qw[3])
      la = lm.qrot(qc, w_w)   # local (inertial-frame) angular velocity
      ll = lm.qrot(qc, v_w)   # local linear velocity
      tq = tuple(-fl["visc_t"] * la[k] -
                 fl["dens_t"][k] * torch.abs(la[k]) * la[k] for k in range(3))
      fr = tuple(-fl["visc_f"] * ll[k] -
                 fl["dens_f"][k] * torch.abs(ll[k]) * ll[k] for k in range(3))
      f_w = lm.qrot(qw, fr)
      t_ref = lm.vadd(lm.qrot(qw, tq), lm.vcross(off, f_w))
      for dof in fl["dofs"]:
        qfrc[dof] = qfrc[dof] + lm.vdot(cdof[dof][0], t_ref) + \
            lm.vdot(cdof[dof][1], f_w)

    act_force = []
    for u in range(nu):
      tid = int(m.actuator_trnid[u, 0])
      uin = ctrl[u]
      if c["ctrllimited"][u]:
        uin = torch.clamp(uin, float(c["ctrlrange"][u][0]),
                          float(c["ctrlrange"][u][1]))
      if int(m.actuator_trntype[u]) == TRN_JOINT:
        dadr = int(m.jnt_dofadr[tid])
        gear = float(c["gear"][u][0])
        length = qpos[int(m.jnt_qposadr[tid])] * gear
        velocity = qvel[dadr] * gear
        moment = {dadr: gear}
      else:  # TRN_SITE: the gear's world wrench at the site
        bid = int(m.site_bodyid[tid])
        gr = c["gear"][u]
        wq = lm.qmul(xquat[bid], lm.const_quat(c["site_quat"][tid], like))
        f_w = lm.qrot(wq, cv(gr[0:3]))
        t_w = lm.qrot(wq, cv(gr[3:6]))
        spos = lm.vadd(xpos[bid],
                       lm.qrot(xquat[bid], cv(c["site_pos"][tid])))
        t_ref = lm.vadd(t_w, lm.vcross(lm.vsub(spos, ref[bid]), f_w))
        dofs = [i for i in range(nv) if m.body_dof_mask[bid][i] > 0]
        moment = {i: lm.vdot(cdof[i][0], t_ref) + lm.vdot(cdof[i][1], f_w)
                  for i in dofs}
        length = like * 0.0
        velocity = sum((moment[i] * qvel[i] for i in dofs), like * 0.0)
      gp = c["gainprm"][u]
      if int(c["gaintype"][u]) == GAIN_FIXED:
        gain = float(gp[0])
      else:
        gain = float(gp[0]) + float(gp[1]) * length + \
            float(gp[2]) * velocity
      force = gain * uin
      if int(c["biastype"][u]) != BIAS_NONE:
        bp = c["biasprm"][u]
        force = force + float(bp[0]) + float(bp[1]) * length + \
            float(bp[2]) * velocity
      if c["forcelimited"][u]:
        force = torch.clamp(force, float(c["forcerange"][u][0]),
                            float(c["forcerange"][u][1]))
      act_force.append(force)
      for i, mom in moment.items():
        qfrc[i] = qfrc[i] + mom * force

    rhs = [qfrc[i] - qfrc_bias[i] for i in range(nv)]

    def integrate_qpos(qpos, qvel_new):
      """Euler position update (free-joint quaternions integrate in the
      local frame)."""
      qpos_new = list(qpos)
      for j in range(m.njnt):
        qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
        if int(m.jnt_type[j]) == FREE:
          for k in range(3):
            qpos_new[qadr + k] = qpos_new[qadr + k] + h * qvel_new[dadr + k]
          w = (qvel_new[dadr + 3], qvel_new[dadr + 4], qvel_new[dadr + 5])
          angle = torch.sqrt(w[0]**2 + w[1]**2 + w[2]**2)
          safe = torch.clamp(angle, min=1e-12)
          axis = (w[0] / safe, w[1] / safe, w[2] / safe)
          half = 0.5 * angle * h
          sh, ch = torch.sin(half), torch.cos(half)
          dq = (ch, axis[0] * sh, axis[1] * sh, axis[2] * sh)
          q0 = (qpos_new[qadr + 3], qpos_new[qadr + 4], qpos_new[qadr + 5],
                qpos_new[qadr + 6])
          qn = lm.qmul(q0, dq)
          norm = torch.sqrt(qn[0]**2 + qn[1]**2 + qn[2]**2 + qn[3]**2)
          inv = 1.0 / torch.clamp(norm, min=1e-12)
          for k in range(4):
            qpos_new[qadr + 3 + k] = qn[k] * inv
        else:
          qpos_new[qadr] = qpos_new[qadr] + h * qvel_new[dadr]
      return qpos_new

    # ---- task residual (pre-step state, full derived context) ----
    res = None
    if residual_fn is not None:
      res = residual_fn(dict(
          m=m, c=c, cv=cv, like=like, h=h, t=t_step, aux=aux,
          aux_dyn=aux_dyn, qpos=qpos, qvel=qvel, ctrl=ctrl, xpos=xpos,
          xquat=xquat, xipos=xipos, subtree_com=subtree_com, ref=ref,
          cvel=cvel, act_force=act_force))
      assert len(res) == residual_dim, (len(res), residual_dim)
    if derived_only:
      return None, None, res

    # ---- constraint rows: joint limits + ground contacts ----
    # one-sided quadratic penalty rows (jrow: nv entries, None =
    # structurally zero; aref; D gate) and per-contact elliptic blocks
    rows = []
    eblocks = []
    for lim in limits:
      qadr, dadr = lim["qadr"], lim["dadr"]
      for sign in (1.0, -1.0):
        if sign > 0:
          pos = qpos[qadr] - lim["lo"] - lim["margin"]
        else:
          pos = lim["hi"] - qpos[qadr] - lim["margin"]
        aref, dcoef = kbi(pos, sign * qvel[dadr], lim["imp"], lim["invw"])
        jrow = [None] * nv
        jrow[dadr] = like * 0.0 + sign
        rows.append((jrow, aref, dcoef))

    def add_rows(con, gap, jdir, vdirs, rot_axes):
      """Rows of one contact point from its direction Jacobians `jdir`
      (normal, tangent 1, tangent 2) and point velocities `vdirs`;
      rot_axes(n) gives the (Jacobian, velocity) of the rotations about the
      first n contact dirs (condim > 3). Frictionless: one one-sided normal row; elliptic:
      a cone block; pyramidal: 2 one-sided rows per friction axis."""
      support, fri = con["support"], con["fri"]
      condim_c = con["condim"]
      if condim_c == 1:
        aref, dcoef = kbi(gap, vdirs[0], con["imp"], max(con["invw"], 1e-12))
        rows.append((jdir[0], aref, dcoef))
        return
      axes = [(jdir[1], vdirs[1], float(fri[0])),
              (jdir[2], vdirs[2], float(fri[1]))]
      if condim_c > 3:
        rot = rot_axes(1 if condim_c == 4 else 3)
        axes += [(row, jv_r, float(fri[ax_i]))
                 for ax_i, (row, jv_r) in zip((2, 3, 4), rot)]
      if c["cone"] == 1:
        # elliptic block: normal row from kbi; friction rows carry
        # aref = -B*jv only, D_i = D_N * (mu_i / mu_eff)^2
        aref_n, dn = kbi(gap, vdirs[0], con["imp"], max(con["invw"], 1e-12))
        b_coef = float(con["imp"][7])
        eblocks.append((
            tuple(support), [jdir[0]] + [a_[0] for a_ in axes],
            [aref_n] + [-b_coef * a_[1] for a_ in axes], dn,
            float(con["mu"]), np.asarray(con["scales"][:len(axes)])))
        return
      for jrow_a, jv_a, mu_f in axes:
        for sign in (1.0, -1.0):
          jrow = [None] * nv
          for i in support:
            jrow[i] = jdir[0][i] + sign * mu_f * jrow_a[i]
          jv = vdirs[0] + sign * mu_f * jv_a
          aref, dcoef = kbi(gap, jv, con["imp"], max(con["iw"], 1e-12))
          rows.append((jrow, aref, dcoef))

    for con in contacts:
      bid, dirs = con["bid"], con["dirs"]
      n_pl, p_pl, r0 = con["n_pl"], con["p_pl"], con["radius"]
      support = con["support"]
      gpos = lm.vadd(xpos[bid], lm.qrot(xquat[bid], cv(con["geom_pos"])))
      h_c = (float(n_pl[0]) * (gpos[0] - float(p_pl[0])) +
             float(n_pl[1]) * (gpos[1] - float(p_pl[1])) +
             float(n_pl[2]) * (gpos[2] - float(p_pl[2])))
      dist = h_c - r0
      pt = lm.vsub(gpos, lm.vscale(cv(n_pl), r0 + 0.5 * dist))
      rvec = lm.vsub(pt, ref[bid])
      jdir = []
      for dvec in dirs:
        row = [None] * nv
        for i in support:
          w2, v2 = cdof[i]
          jp = lm.vadd(v2, lm.vcross(w2, rvec))
          row[i] = jp[0] * float(dvec[0]) + jp[1] * float(dvec[1]) + \
              jp[2] * float(dvec[2])
        jdir.append(row)
      wv, vv = cvel[bid]
      pv = lm.vadd(vv, lm.vcross(wv, rvec))
      vdirs = [pv[0] * float(d_[0]) + pv[1] * float(d_[1]) +
               pv[2] * float(d_[2]) for d_ in dirs]

      def ground_rot(n, support=support, dirs=dirs, wv=wv):
        # angular Jacobian rows about the first n static frame dirs (the
        # plane is world-static: only the body's dofs move)
        out = []
        for dvec in dirs[:n]:
          row = [None] * nv
          for i in support:
            wd = cdof[i][0]
            row[i] = wd[0] * float(dvec[0]) + \
                wd[1] * float(dvec[1]) + wd[2] * float(dvec[2])
          out.append((row, wv[0] * float(dvec[0]) +
                      wv[1] * float(dvec[1]) + wv[2] * float(dvec[2])))
        return out

      add_rows(con, dist - con["incm"], jdir, vdirs, ground_rot)

    # body-body contacts: narrowphase per candidate, a frame built from the
    # traced normal, both bodies' Jacobians (b2 plus, b1 minus), each body
    # about its own root's subtree com
    for bc in bodies:
      pt, dist, nrm = body_contact_point(bc, xpos, xquat, cv)
      b1, b2, support = bc["b1"], bc["b2"], bc["support"]
      cond = (torch.abs(nrm[0]) < 0.5).to(like.dtype)
      t1, _ = _vnormalize(lm.vcross(nrm, (cond, 1.0 - cond, like * 0.0)))
      dirs = [nrm, t1, lm.vcross(nrm, t1)]
      jdir = []
      for dvec in dirs:
        row = [None] * nv
        for i in support:
          acc = None
          for bb, sgn in ((b2, 1.0), (b1, -1.0)):
            if m.body_dof_mask[bb][i] > 0:
              w2, v2 = cdof[i]
              jp = lm.vadd(v2, lm.vcross(w2, lm.vsub(pt, ref[bb])))
              term = sgn * lm.vdot(jp, dvec)
              acc = term if acc is None else acc + term
          row[i] = acc
        jdir.append(row)

      def pvel(bb):
        w, v = cvel[bb]
        return lm.vadd(v, lm.vcross(w, lm.vsub(pt, ref[bb])))

      pv = lm.vsub(pvel(b2), pvel(b1))
      vdirs = [lm.vdot(pv, d_) for d_ in dirs]

      def body_rot(n, support=support, dirs=dirs, b1=b1, b2=b2):
        # the relative angular Jacobian about the first n traced frame dirs
        wrel = lm.vsub(cvel[b2][0], cvel[b1][0])
        out = []
        for dvec in dirs[:n]:
          row = [None] * nv
          for i in support:
            acc = None
            for bb, sgn in ((b2, 1.0), (b1, -1.0)):
              if m.body_dof_mask[bb][i] > 0:
                term = sgn * lm.vdot(cdof[i][0], dvec)
                acc = term if acc is None else acc + term
            row[i] = acc
          out.append((row, lm.vdot(wrel, dvec)))
        return out

      add_rows(bc, dist - bc["incm"], jdir, vdirs, body_rot)

    # ---- support-grouped Newton constraint solve ----
    M = torch.stack([torch.stack(r) for r in mrows])      # (nv, nv, K)
    rhs_p = torch.stack(rhs)                              # (nv, K)
    if rows or eblocks:
      zero = like * 0.0
      groups = {}
      for jrow, aref, dcoef in rows:
        sup = tuple(i for i in range(nv) if jrow[i] is not None)
        groups.setdefault(sup, []).append((jrow, aref, dcoef))
      packed = []
      for sup, grows in groups.items():
        jg = torch.stack([torch.stack([jrow[i] + zero for i in sup])
                          for jrow, _, _ in grows])       # (ng, ns, K)
        arefg = torch.stack([aref + zero for _, aref, _ in grows])
        dcoefg = torch.stack([dcoef + zero for _, _, dcoef in grows])
        packed.append((sup, jg, arefg, dcoefg))

      # elliptic cone blocks stay per-contact (rows are coupled by the
      # zone logic)
      epacked = []
      for sup, jrows, arefs, dn, mu, scales in eblocks:
        jrs = [[jr[i] + zero for i in sup] for jr in jrows]
        epacked.append((sup, jrs, [ar + zero for ar in arefs],
                        dn + zero, mu, scales))

      def group_jar(a, sup, jg, arefg):
        ag = torch.stack([a[i] for i in sup])             # (ns, K)
        return torch.sum(jg * ag[None, :, :], dim=1) - arefg

      def ell_jar(a, sup, jrs, arefs):
        asup = [a[i] for i in sup]
        return [sum(jr[il] * asup[il] for il in range(len(sup))) - ar
                for jr, ar in zip(jrs, arefs)]

      def ell_terms(jar_rows, dn, mu, scales):
        """Elliptic cone cost expansion at jar. Zones in the scaled space
        s_i = jar_i * scale_i, t = ||s||: bottom (mu*n + t <= 0) full
        quadratic; top (n >= mu*t) zero force; middle convex cost
        0.5*D_N/(1+mu^2)*(n - mu t)^2 with the exact cone Hessian
        (diag + w_mid gz gz^T - w_cone cs cs^T). Returns (g rows,
        h diagonal rows, w_mid, gz rows, w_cone, cs rows)."""
        n_ = jar_rows[0]
        nf = len(scales)
        s_rows = [jar_rows[1 + i] * float(scales[i]) for i in range(nf)]
        t = torch.sqrt(sum(sr * sr for sr in s_rows))
        tsafe = torch.clamp(t, min=1e-12)
        bottom = (mu * n_ + t) <= 0.0
        middle = (~bottom) & (n_ < mu * t)
        w_coef = dn / (1.0 + mu * mu)
        z = n_ - mu * t
        shat = [sr / tsafe for sr in s_rows]
        gz = [torch.ones_like(n_)] + \
            [-mu * shat[i] * float(scales[i]) for i in range(nf)]
        cs = [torch.zeros_like(n_)] + \
            [shat[i] * float(scales[i]) for i in range(nf)]
        zeros = torch.zeros_like(n_)
        wz = torch.where(middle, w_coef * z, zeros)
        d_act = torch.where(bottom, dn, zeros)
        w_cone = torch.where(middle, w_coef * (-z) * mu / tsafe, zeros)
        g = [d_act * jar_rows[0] + wz * gz[0]]
        hd = [d_act]
        for i in range(nf):
          r2 = float(scales[i]) ** 2
          g.append(d_act * r2 * jar_rows[1 + i] + wz * gz[1 + i])
          hd.append(d_act * r2 + w_cone * r2)
        w_mid = torch.where(middle, w_coef, zeros)
        return g, hd, w_mid, gz, w_cone, cs

      # masked Newton on qacc with a safeguarded exact 1-D line search
      a0 = lm.chol_solve_packed(M, rhs_p)                 # qacc_smooth
      a = a0
      for _ in range(n_newton):
        ma = torch.sum(M * (a - a0)[None, :, :], dim=1)   # (nv, K)
        grad_l = [None] * nv
        hupper = [[None] * nv for _ in range(nv)]         # global i <= j
        jars = []
        for sup, jg, arefg, dcoefg in packed:
          jar_g = group_jar(a, sup, jg, arefg)            # (ng, K)
          act_g = dcoefg * (jar_g < 0)
          jars.append(jar_g)
          gpart = torch.sum(jg * (act_g * jar_g)[:, None, :], dim=0)
          ns = len(sup)
          for il, i in enumerate(sup):
            gi = gpart[il]
            grad_l[i] = gi if grad_l[i] is None else grad_l[i] + gi
            for jl in range(il, ns):
              jdof = sup[jl]
              hij = torch.sum(act_g * jg[:, il, :] * jg[:, jl, :], dim=0)
              if hupper[i][jdof] is None:
                hupper[i][jdof] = hij
              else:
                hupper[i][jdof] = hupper[i][jdof] + hij
        e_jars, e_gs = [], []
        for sup, jrs, arefs, dn, mu, scales in epacked:
          jar_rows = ell_jar(a, sup, jrs, arefs)
          g_r, h_r, w_mid, gz, w_cone, cs = ell_terms(
              jar_rows, dn, mu, scales)
          e_jars.append(jar_rows)
          e_gs.append(g_r)
          ns = len(sup)
          ngr = len(jrs)
          v_l = [sum(gz[r] * jrs[r][il] for r in range(ngr))
                 for il in range(ns)]
          u_l = [sum(cs[r] * jrs[r][il] for r in range(ngr))
                 for il in range(ns)]
          for il, i in enumerate(sup):
            gi = sum(jrs[r][il] * g_r[r] for r in range(ngr))
            grad_l[i] = gi if grad_l[i] is None else grad_l[i] + gi
            for jl in range(il, ns):
              jdof = sup[jl]
              hij = sum(h_r[r] * jrs[r][il] * jrs[r][jl]
                        for r in range(ngr)) + \
                  w_mid * v_l[il] * v_l[jl] - w_cone * u_l[il] * u_l[jl]
              if hupper[i][jdof] is None:
                hupper[i][jdof] = hij
              else:
                hupper[i][jdof] = hupper[i][jdof] + hij
        grad = torch.stack([g if g is not None else zero for g in grad_l])

        def hentry(i, j):
          lo_, hi_ = (i, j) if j >= i else (j, i)
          extra = hupper[lo_][hi_]
          return mrows[i][j] if extra is None else mrows[i][j] + extra

        hfull = torch.stack([torch.stack([hentry(i, j) for j in range(nv)])
                             for i in range(nv)])
        pstep = -lm.chol_solve_packed(hfull, ma + grad)
        if n_ls > 0:
          # Safeguarded exact line search along pstep (piecewise-quadratic
          # convex phi, so phi' is monotone): bracket phi''s root, Newton
          # steps clipped into the bracket with regula-falsi fallback.
          mp = torch.sum(M * pstep[None, :, :], dim=1)
          pmp = torch.sum(pstep * mp, dim=0)                  # (K,)
          pma = torch.sum(pstep * ma, dim=0)
          jpss = []
          for sup, jg, arefg, dcoefg in packed:
            psg = torch.stack([pstep[i] for i in sup])
            jpss.append(torch.sum(jg * psg[None, :, :], dim=1))
          ejpss = []
          for sup, jrs, arefs, dn, mu, scales in epacked:
            psup = [pstep[i] for i in sup]
            ejpss.append([sum(jr[il] * psup[il]
                              for il in range(len(sup))) for jr in jrs])

          def dphi_lane(tls):
            dphi = pma + tls * pmp
            ddphi = pmp
            for (sup, jg, arefg, dcoefg), jar_g, jps_g in zip(
                packed, jars, jpss):
              jart = jar_g + tls[None, :] * jps_g
              act2 = dcoefg * (jart < 0)
              dphi = dphi + torch.sum(act2 * jart * jps_g, dim=0)
              ddphi = ddphi + torch.sum(act2 * jps_g * jps_g, dim=0)
            for (sup, jrs, arefs, dn, mu, scales), jar_rows, jps_r in \
                zip(epacked, e_jars, ejpss):
              jart_rows = [jr_ + tls * jp_ for jr_, jp_ in
                           zip(jar_rows, jps_r)]
              g_t, h_t, w_mid_t, gz_t, w_cone_t, cs_t = ell_terms(
                  jart_rows, dn, mu, scales)
              ngr = len(jrs)
              dphi = dphi + sum(g_t[r] * jps_r[r] for r in range(ngr))
              vp = sum(gz_t[r] * jps_r[r] for r in range(ngr))
              up = sum(cs_t[r] * jps_r[r] for r in range(ngr))
              ddphi = ddphi + sum(h_t[r] * jps_r[r] * jps_r[r]
                                  for r in range(ngr)) + \
                  w_mid_t * vp * vp - w_cone_t * up * up
            return dphi, ddphi

          # Zero-extra-evaluation safeguard: the bracket is built from
          # the n_ls Newton evaluations themselves. _BIG is the "no upper
          # bracket yet" sentinel; until one exists, growth is capped
          # geometrically (4x) per iteration.
          _BIG = 1e6
          one = torch.ones_like(like)
          zero = torch.zeros_like(like)
          # dphi(0) reuses the activations already computed at a (t=0)
          dlo = pma + zero
          for (sup, jg, arefg, dcoefg), jar_g, jps_g in zip(
              packed, jars, jpss):
            act0 = dcoefg * (jar_g < 0)
            dlo = dlo + torch.sum(act0 * jar_g * jps_g, dim=0)
          for g_r, jps_r in zip(e_gs, ejpss):
            dlo = dlo + sum(g_r[r] * jps_r[r] for r in range(len(g_r)))
          lo = zero
          hi = torch.full_like(like, _BIG)
          dhi = torch.zeros_like(like)
          tls = one
          for _ in range(n_ls):
            dphi, ddphi = dphi_lane(tls)
            neg = dphi < 0
            lo = torch.where(neg, tls, lo)
            dlo = torch.where(neg, dphi, dlo)
            hi = torch.where(neg, hi, tls)
            dhi = torch.where(neg, dhi, dphi)
            t_n = tls - dphi / torch.clamp(ddphi, min=1e-12)
            # fallback when Newton exits the bracket: regula falsi on a
            # real bracket; geometric growth while unbracketed above
            denom = dhi - dlo
            t_s = lo - dlo * (hi - lo) / torch.where(
                torch.abs(denom) < 1e-12, one, denom)
            t_s = torch.minimum(torch.maximum(t_s, lo), hi)
            inb = (t_n > lo) & (t_n < hi)
            raw = torch.where(inb, t_n, t_s)
            cap = 4.0 * torch.maximum(tls, one)
            unbracketed = hi >= _BIG
            tls = torch.where(
                unbracketed,
                torch.minimum(torch.maximum(
                    torch.where(inb, t_n, tls), lo), cap),
                raw)
          tls = torch.minimum(torch.maximum(tls, zero), hi)
          a = a + tls[None, :] * pstep
        else:
          a = a + pstep
      rhs_l = list(rhs)
      for sup, jg, arefg, dcoefg in packed:
        jar_g = group_jar(a, sup, jg, arefg)
        act_g = dcoefg * (jar_g < 0)
        fpart = torch.sum(jg * (act_g * jar_g)[:, None, :], dim=0)
        for il, i in enumerate(sup):
          rhs_l[i] = rhs_l[i] - fpart[il]
      for sup, jrs, arefs, dn, mu, scales in epacked:
        jar_rows = ell_jar(a, sup, jrs, arefs)
        g_r = ell_terms(jar_rows, dn, mu, scales)[0]
        for il, i in enumerate(sup):
          rhs_l[i] = rhs_l[i] - sum(jrs[r][il] * g_r[r]
                                    for r in range(len(jrs)))
      rhs_p = torch.stack(rhs_l)

    # ---- implicit-damping Euler ----
    for i in range(nv):
      mrows[i][i] = mrows[i][i] + h * float(c["dof_damping"][i])
    m_e = torch.stack([torch.stack(r) for r in mrows])
    qacc_p = lm.chol_solve_packed(m_e, rhs_p)
    qvel_new = [qvel[i] + h * qacc_p[i] for i in range(nv)]
    return integrate_qpos(qpos, qvel_new), qvel_new, res

  return step_body


# ---- constant tables of the CUDA kernel -------------------------------------


def _d1(n: int) -> int:
  return max(int(n), 1)


def _pad(a, shape, dtype) -> np.ndarray:
  """`a` zero-padded to `shape` (the kernel's arrays are never empty)."""
  out = np.zeros(shape, dtype)
  a = np.asarray(a, dtype=dtype)
  if a.size:
    out[tuple(slice(0, s) for s in a.shape)] = a
  return out


def _pack_tables(m: Model, c: dict, limits: list, contacts: list,
                 bodies: list, fluid: list, cost_terms, residual,
                 table_float=np.float32) -> tuple:
  """Bytes of the kernel's tables (field order of `TablesHead`, then of
  `ContactTables` in ops/csrc/lane_rollout.cu, then the task's constant
  block) and the dimensions they imply. Contact index ci runs over the
  ground contact points, then the body contact entries."""
  nb, nj, nv, nu, nq = m.nbody, m.njnt, m.nv, m.nu, m.nq
  allc = contacts + bodies
  nlimj, ncon, nbcon, nct = len(limits), len(contacts), len(bodies), \
      len(allc)
  nsup = max([len(con["support"]) for con in allc] + [1])
  elliptic = c["cone"] == 1
  # pyramidal / condim-1 rows in contact order; a pyramidal contact's rows
  # start at con_prow[ci]
  prow_smu, con_prow, econ_con = [], [], []
  for ci, con in enumerate(allc):
    con_prow.append(len(prow_smu))
    if con["condim"] == 1:
      prow_smu.append(0.0)
    elif elliptic:
      econ_con.append(ci)
    else:
      for a in range(con["condim"] - 1):
        for sign in (1.0, -1.0):
          prow_smu.append(sign * float(con["fri"][a]))
  nprow, necon = len(prow_smu), len(econ_con)
  nterm = len(cost_terms) if cost_terms else 0
  anc = np.asarray(m.dof_ancestor_mask) > 0
  h = c["timestep"]
  i32, f32 = np.int32, table_float
  tid = [int(m.actuator_trnid[u, 0]) for u in range(nu)]
  site = [int(m.actuator_trntype[u]) == TRN_SITE for u in range(nu)]
  jtid = [0 if site[u] else tid[u] for u in range(nu)]
  stid = [tid[u] if site[u] else 0 for u in range(nu)]
  sup = np.zeros((_d1(nct), nsup), i32)
  for ci, con in enumerate(allc):
    sup[ci, :len(con["support"])] = con["support"]

  def actcols(key, ncol):
    a = np.asarray(c[key], np.float64)
    return a.reshape(nu, -1)[:, :ncol] if nu else np.zeros((0, ncol))

  def nfscales(con):
    out = np.zeros(5)
    out[:con["condim"] - 1] = con["scales"][:con["condim"] - 1]
    return out

  def col(rows, key, dtype, shape):
    return (_pad([con[key] for con in rows], shape, dtype), dtype, shape)

  fluid_on = np.zeros(nb, i32)
  for fl in fluid:
    fluid_on[fl["body"]] = 1
  # the tree by levels: bodies ordered by depth (the world alone at depth
  # 0), where each level starts, and each body's children in descending
  # index order (the order a serial sum over the bodies adds them in)
  parent = [int(v) for v in np.asarray(m.body_parentid)]
  depth = [0] * nb
  for b in range(1, nb):
    depth[b] = depth[parent[b]] + 1
  nlvl = max(depth) if nb > 1 else 0
  lvl_body = sorted(range(nb), key=lambda b: (depth[b], b))
  lvl_start = [sum(1 for b in range(nb) if depth[b] < d)
               for d in range(nlvl + 2)]
  children = [[c for c in range(nb - 1, 0, -1) if parent[c] == b]
              for b in range(nb)]
  child_start = np.cumsum([0] + [len(ch) for ch in children])
  child_list = [c for ch in children for c in ch]

  def fluid_col(get, width):
    out = np.zeros((nb, width), np.float64)
    for fl in fluid:
      out[fl["body"]] = get(fl)
    return out

  head = [
      (m.body_parentid, i32, (nb,)), (m.body_rootid, i32, (nb,)),
      (m.body_jntadr, i32, (nb,)), (m.body_jntnum, i32, (nb,)),
      (m.body_dofadr, i32, (nb,)), (m.body_dofnum, i32, (nb,)),
      (m.jnt_type, i32, (_d1(nj),)), (m.jnt_qposadr, i32, (_d1(nj),)),
      (m.jnt_dofadr, i32, (_d1(nj),)), (m.jnt_bodyid, i32, (_d1(nj),)),
      (m.dof_bodyid, i32, (_d1(nv),)), (m.dof_jntid, i32, (_d1(nv),)),
      (anc | anc.T, i32, (_d1(nv), _d1(nv))),
      ([int(m.jnt_qposadr[t]) for t in jtid], i32, (_d1(nu),)),
      ([int(m.jnt_dofadr[t]) for t in jtid], i32, (_d1(nu),)),
      (np.asarray(c["gaintype"]) == GAIN_FIXED, i32, (_d1(nu),)),
      (np.asarray(c["biastype"]) != BIAS_NONE, i32, (_d1(nu),)),
      (np.asarray(c["ctrllimited"]) != 0, i32, (_d1(nu),)),
      (np.asarray(c["forcelimited"]) != 0, i32, (_d1(nu),)),
      ([l["qadr"] for l in limits], i32, (_d1(nlimj),)),
      ([l["dadr"] for l in limits], i32, (_d1(nlimj),)),
      ([t for t, _ in (cost_terms or ())], i32, (_d1(nterm),)),
      ([d for _, d in (cost_terms or ())], i32, (_d1(nterm),)),
      (np.asarray(m.body_dof_mask) > 0, i32, (nb, _d1(nv))),
      (fluid_on, i32, (nb,)),
      (lvl_body, i32, (nb,)), (lvl_start, i32, (nlvl + 2,)),
      (child_start, i32, (nb + 1,)), (child_list, i32, (_d1(nb - 1),)),
      ([h], f32, (1,)), (c["gravity"], f32, (3,)),
      (c["body_pos"], f32, (nb, 3)), (c["body_quat"], f32, (nb, 4)),
      (c["body_ipos"], f32, (nb, 3)), (c["body_iquat"], f32, (nb, 4)),
      (c["body_mass"], f32, (nb,)), (c["body_inertia"], f32, (nb, 3)),
      (1.0 / np.maximum(np.asarray(c["body_subtreemass"], np.float64),
                        1e-12), f32, (nb,)),
      (c["jnt_pos"], f32, (_d1(nj), 3)), (c["jnt_axis"], f32, (_d1(nj), 3)),
      (c["jnt_stiffness"], f32, (_d1(nj),)),
      (c["qpos0"], f32, (_d1(nq),)), (c["qpos_spring"], f32, (_d1(nq),)),
      (c["dof_damping"], f32, (_d1(nv),)),
      (h * np.asarray(c["dof_damping"], np.float64), f32, (_d1(nv),)),
      (c["dof_armature"], f32, (_d1(nv),)),
      (actcols("gear", 1)[:, 0], f32, (_d1(nu),)),
      (actcols("gainprm", 3), f32, (_d1(nu), 3)),
      (actcols("biasprm", 3), f32, (_d1(nu), 3)),
      (c["ctrlrange"], f32, (_d1(nu), 2)),
      (c["forcerange"], f32, (_d1(nu), 2)),
      ([l["lo"] for l in limits], f32, (_d1(nlimj),)),
      ([l["hi"] for l in limits], f32, (_d1(nlimj),)),
      ([l["margin"] for l in limits], f32, (_d1(nlimj),)),
      ([l["invw"] for l in limits], f32, (_d1(nlimj),)),
      ([l["imp"] for l in limits], f32, (_d1(nlimj), 9)),
      (c["wind"], f32, (3,)),
      (fluid_col(lambda fl: [fl["visc_t"], fl["visc_f"]], 2), f32, (nb, 2)),
      (fluid_col(lambda fl: fl["dens_f"], 3), f32, (nb, 3)),
      (fluid_col(lambda fl: fl["dens_t"], 3), f32, (nb, 3)),
      (site, i32, (_d1(nu),)),
      ([int(m.site_bodyid[t]) for t in stid] if any(site) else [], i32,
       (_d1(nu),)),
      ([c["site_pos"][t] for t in stid] if any(site) else [], f32,
       (_d1(nu), 3)),
      ([c["site_quat"][t] for t in stid] if any(site) else [], f32,
       (_d1(nu), 4)),
      (actcols("gear", 6), f32, (_d1(nu), 6)),
  ]
  # per contact point (ground, then body entries) and per row
  nc1, nct1 = (_d1(ncon),), (_d1(nct),)
  contact = [
      ([con["bid"] for con in contacts], i32, nc1),
      ([con["condim"] for con in allc], i32, nct1),
      ([len(con["support"]) for con in allc], i32, nct1),
      (sup, i32, sup.shape),
      (con_prow, i32, nct1),
      col(contacts, "geom_pos", f32, (_d1(ncon), 3)),
      col(contacts, "radius", f32, nc1),
      col(contacts, "p_pl", f32, (_d1(ncon), 3)),
      col(contacts, "dirs", f32, (_d1(ncon), 3, 3)),
      col(allc, "imp", f32, (_d1(nct), 9)),
      col(allc, "incm", f32, nct1),
      ([max(con["invw"], 1e-12) for con in allc], f32, nct1),
      ([max(con["iw"], 1e-12) for con in allc], f32, nct1),
      col(allc, "mu", f32, nct1),
      ([1.0 + con["mu"] ** 2 for con in allc], f32, nct1),
      # scales past a contact's own friction axes are zero (see EROWS)
      ([nfscales(con) for con in allc], f32, (_d1(nct), 5)),
      ([nfscales(con) ** 2 for con in allc], f32, (_d1(nct), 5)),
      (prow_smu, f32, (_d1(nprow),)),
  ]
  if bodies:
    nb1 = (nbcon,)
    contact += [(_pad([bc[key] for bc in bodies], nb1, i32), i32, nb1)
                for key in ("kind", "b1", "b2", "ba", "bb", "flip")]
    contact += [col(bodies, key, f32, (nbcon,) + np.shape(bodies[0][key]))
                for key in ("pa", "ra", "pb", "ua", "ub", "ha", "hb", "rb",
                            "qb", "sb")]
  task = [(v, f32 if dt == np.float32 else dt, np.asarray(v).shape)
          for _, dt, v in residual["consts"]] if residual is not None \
      else [([0], i32, (1,))]

  def pack(fields):
    return b"".join(_pad(v, shape, dt).tobytes() for v, dt, shape in fields)

  blob_head, blob_contact, blob_task = pack(head), pack(contact), pack(task)
  blob = blob_head + blob_contact + blob_task
  # rows every elliptic block carries: the largest condim among them
  erows = max([allc[ci]["condim"] for ci in econ_con] + [1])
  dims = dict(NLIMJ=nlimj, NCON=ncon, NBCON=nbcon, BODY=int(nbcon > 0),
              NLVL=nlvl,
              NPROW=nprow, NECON=necon, NSUP=nsup, EROWS=erows,
              FLUID=int(bool(fluid)), SITE=int(any(site)))
  return blob, dims


# Threads a block of the rollout kernel may have (its __launch_bounds__),
# and the dynamic shared memory a block may opt into on an H100.
MAX_THREADS, SMEM_MAX = 256, 232448
# Scalar rows and elliptic blocks a team keeps in shared memory; active
# rows past them go to a per-candidate global workspace. A model whose
# scalar rows are limit sides only (Quadruped Flat: 24, rarely active)
# keeps LIMIT_ROW_CAP of them, so that two blocks of teams share an SM.
ROW_CAP, LIMIT_ROW_CAP, BLK_CAP = 64, 8, 8


def team_size(nv: int, ncontacts: int) -> int:
  """Lanes of the rollout kernel's team per candidate (LR_TEAM), from the
  model's dofs and contact points. Measured with scripts/torch_lane_sweep.py
  (PERF.md): a full warp for the big models (Rubik, the humanoid: nv 21-27,
  75-230 contact points, planned at K=512, where each SM holds only ~4
  candidates and the lanes are the parallelism there is) and for Quadruped
  Flat (nv 18, K=4096: a lane per dof lets the Cholesky factorisations
  keep a row in each lane), 8 for the small ones."""
  if nv >= 16 or ncontacts > 32:
    return 32
  return 8


def teams_per_block(k: int, team: int, smem_bytes: Callable[[int], int],
                    n_sm: int) -> int:
  """Teams in a block of the rollout kernel: enough blocks to give every SM
  one (K / n_sm teams each), within MAX_THREADS threads and SMEM_MAX bytes
  of shared memory (`smem_bytes(teams)`)."""
  tpb = max(1, min(-(-k // max(n_sm, 1)), MAX_THREADS // team))
  while tpb > 1 and smem_bytes(tpb) > SMEM_MAX:
    tpb -= 1
  return tpb


def build_rollout_kernel(m: Model, horizon: int, num_nodes: int,
                         contact_types=None, contact_geoms=None,
                         solver_iters=None, solver_ls_iters=None,
                         residual: Optional[dict] = None, naux: int = 0,
                         record_states: bool = True,
                         cost_terms=None, feedback: bool = False,
                         body_pairs: bool = False, body_pair_types=None, *,
                         _team: Optional[int] = None,
                         _teams_per_block: Optional[int] = None,
                         _row_cap: Optional[int] = None,
                         _blk_cap: Optional[int] = None,
                         _profile: bool = False,
                         _table_float=np.float32) -> Callable:
  """Returns fn(qpos0 (nq,K), qvel0 (nv,K), values (P*nu,K), aux=None) for
  a zero-order-hold spline with node_of_step[t] = min(floor(t*P/(H-1)),
  P-1) (the planner's uniform grid).

  Outputs, by mode:
    record_states=True: states (horizon, nq+nv+nr, K), the pre-step state
      (and residual rows, if `residual` is given) of every step;
    record_states=False, cost_terms=None: (residual rows (horizon, nr, K),
      final state (nq+nv, K));
    record_states=False, cost_terms=((norm_type, dim), ...): (per-term
      UNWEIGHTED norm sums over the horizon (nterm, K), final state).
      Weights stay outside the kernel; norm parameters ride 2*nterm extra
      aux rows appended after the task's `naux` rows.

  `residual` is a task's lane residual spec: `fn` (plain PyTorch residual
  on the step context), `dim`, `header` (CUDA device function under
  ops/csrc) and `consts` (its constant table), and optionally
  `naux_static`: the number of leading aux rows the residual reads as
  `aux` (default all `naux`); rows past them are per-step rows the residual
  reads through `aux_dyn(i)` (the device function through `aux_at(i)`,
  from global memory). It is evaluated once per step on the pre-step
  state. solver_iters / solver_ls_iters default to the model's own
  schedule.

  Planning contacts: the ground pairs of `contact_types` (geom types of the
  non-plane geom) whose geom is in `contact_geoms` (both default to all);
  with `body_pairs=True` also the body-body pairs of `body_pair_types`
  ((type1, type2) pairs; default all six sphere / capsule / box types)
  whose two geoms are in `contact_geoms`. Other pairs are dropped from the
  planning dynamics, as in the JAX package.

  With `feedback=True` (recorded states only; `num_nodes` is not used) the
  callable is fn(qpos0, qvel0, values (2,K), aux, table (horizon*stride,))
  and the control of step t is
    u = clip(u_nom[t] + alpha k[t] + scale K[t] dx, ctrlrange)
  with alpha = values[0], scale = values[1] per candidate, dx the tangent
  difference [qpos (-) x_nom.qpos; qvel - x_nom.qvel] (subtraction for
  hinge/slide joints, the quaternion log map for a free joint) and
  `table` the per-step blocks [u_nom (nu), k (nu), K (nu x 2nv, row-major),
  x_nom (nq+nv)], stride = 2nu + 2nu*nv + nq + nv, shared by all
  candidates (`.stride`, `.feedback_ctrl` expose the layout and the law).

  The underscored arguments are for measuring tools and tests only:
  `_team` lanes per candidate (default `team_size`), `_teams_per_block`
  teams in a CUDA block (default `teams_per_block`), `_row_cap` /
  `_blk_cap` the active scalar rows / elliptic blocks a team keeps in
  shared memory before the global workspace (default ROW_CAP / BLK_CAP,
  cut to what the model can have), `_profile` compiles the per-section
  cycle and active-row counters in (scripts/torch_lane_profile.py),
  `_table_float` is the element type of the packed float tables (a
  host-compiled float64 build of the source, tests).

  Tensors on a CUDA device go through the CUDA kernel (built at first
  use); CPU tensors through the plain PyTorch version. The returned
  callable carries `.step_array` and `.residual_array` (plain version of
  one step on (dim, K) tensors).
  """
  missing = unsupported(m, ground_only=True, body_pairs=body_pairs)
  if missing is not None:
    raise NotImplementedError(
        f"model outside the rollout kernel's class, as in the JAX package: "
        f"{missing} (ball joints, equality constraints, friction loss and "
        "activation states are outside it)")
  c = _static(m)
  nq, nv, nu = m.nq, m.nv, m.nu
  n_newton = int(m.opt.iterations) if solver_iters is None \
      else int(solver_iters)
  n_ls = int(m.opt.ls_iterations) if solver_ls_iters is None \
      else int(solver_ls_iters)
  h = c["timestep"]
  node_of_step = [min(int(t * num_nodes / max(horizon - 1, 1)),
                      num_nodes - 1) for t in range(horizon)]
  limits = _limit_plan(m, c)
  contacts = _contact_plan(m, c, contact_types, contact_geoms)
  bodies = _body_plan(m, c, body_pair_types, contact_geoms) \
      if body_pairs else []
  fluid = _fluid_plan(m, c)
  ndx = 2 * nv
  stride = 2 * nu + nu * ndx + nq + nv
  if feedback and not record_states:
    raise ValueError("feedback=True records states (record_states=True)")
  ctrl_lo = [float(c["ctrlrange"][u][0]) for u in range(nu)]
  ctrl_hi = [float(c["ctrlrange"][u][1]) for u in range(nu)]

  residual_fn = residual["fn"] if residual is not None else None
  nr = int(residual["dim"]) if residual is not None else 0
  # leading aux rows the residual reads as `aux` (the kernel keeps them in
  # registers); the rest are per-step rows read through `aux_dyn`
  naux_static = int(residual.get("naux_static", naux)) \
      if residual is not None else 0
  if not 0 <= naux_static <= naux:
    raise ValueError(f"naux_static {naux_static} outside [0, {naux}]")
  nterm = len(cost_terms) if cost_terms else 0
  if not record_states and residual is None:
    raise ValueError("record_states=False requires an in-kernel residual")
  if cost_terms and (record_states or
                     sum(d for _, d in cost_terms) != nr):
    raise ValueError("cost_terms need record_states=False and dims that "
                     f"add up to the residual's {nr} rows")
  naux_kernel = naux + 2 * nterm
  mode = MODE_STATES if record_states else (
      MODE_COST_SUMS if cost_terms else MODE_RESIDUALS)

  step_body = _make_step_body(m, c, limits, contacts, bodies, fluid,
                              n_newton, n_ls, residual_fn, nr)

  def feedback_ctrl(t, qpos, qvel, alpha, scale, table):
    """The feedback law on component lists: table is (horizon, stride)."""
    row = table[t]
    xb = 2 * nu + nu * ndx
    dx = [None] * nv
    for j in range(m.njnt):
      jt, qa, da = int(m.jnt_type[j]), int(m.jnt_qposadr[j]), \
          int(m.jnt_dofadr[j])
      if jt == FREE:
        for i in range(3):
          dx[da + i] = qpos[qa + i] - row[xb + qa + i]
        qa, da = qa + 3, da + 3
      if jt == FREE:
        rot = lm.quat_sub_tangent(
            tuple(qpos[qa + i] for i in range(4)),
            tuple(row[xb + qa + i] for i in range(4)))
        for i in range(3):
          dx[da + i] = rot[i]
      else:   # hinge / slide: plain subtraction
        dx[da] = qpos[qa] - row[xb + qa]
    dx = dx + [qvel[i] - row[xb + nq + i] for i in range(nv)]
    us = []
    for u in range(nu):
      cff = row[u] + alpha * row[nu + u]
      g0 = 2 * nu + u * ndx
      acc = row[g0] * dx[0]
      for i in range(1, ndx):
        acc = acc + row[g0 + i] * dx[i]
      us.append(torch.clamp(cff + scale * acc, ctrl_lo[u], ctrl_hi[u]))
    return us

  def term_costs(res, norm_p):
    out = []
    off = 0
    for k_t, (ntype, dim) in enumerate(cost_terms):
      p_, q_ = norm_p[2 * k_t], norm_p[2 * k_t + 1]
      out.append(lane_term_cost(res[off:off + dim], ntype, p_, q_))
      off += dim
    return out

  def rollout_plain(qpos0, qvel0, values, aux=None, table=None):
    """The whole rollout as plain PyTorch ops (any device)."""
    if feedback:
      table = table.reshape(horizon, stride)
    qpos = [qpos0[i] for i in range(nq)]
    qvel = [qvel0[i] for i in range(nv)]
    aux_rows = norm_p = aux_dyn = None
    if residual is not None:
      aux_rows = [aux[i] for i in range(naux)]
      aux_dyn = lambda i: aux[i]
      if cost_terms:
        norm_p = [aux[naux + i] for i in range(2 * nterm)]
    sums = [torch.zeros_like(qpos[0]) for _ in range(nterm)]
    recorded = []
    for t in range(horizon):
      if feedback:
        ctrl = feedback_ctrl(t, qpos, qvel, values[0], values[1], table)
      else:
        node = node_of_step[t]
        ctrl = [values[node * nu + u] for u in range(nu)]
      new_qpos, new_qvel, res = step_body(qpos, qvel, ctrl, t, aux_rows,
                                          aux_dyn=aux_dyn)
      if cost_terms:
        sums = [s_ + c_ for s_, c_ in zip(sums, term_costs(res, norm_p))]
      elif record_states:
        recorded.append(torch.stack(qpos + qvel + (res or [])))
      else:
        recorded.append(torch.stack(res))
      qpos, qvel = new_qpos, new_qvel
    if record_states:
      return torch.stack(recorded)
    final = torch.stack(qpos + qvel)
    if cost_terms:
      return torch.stack(sums), final
    return torch.stack(recorded), final

  # ---- CUDA route: built and loaded at the first launch ----
  state = dict(lib=None, blob=None, ws={})

  def defines():
    blob, dims = _pack_tables(m, c, limits, contacts, bodies, fluid,
                              cost_terms, residual, _table_float)
    header = residual["header"] if residual is not None \
        else "residual_none.cuh"
    team = int(_team) if _team is not None else team_size(
        nv, dims["NCON"] + dims["NBCON"])
    max_rows = 2 * dims["NLIMJ"] + dims["NPROW"]
    cap = ROW_CAP if dims["NPROW"] else LIMIT_ROW_CAP
    row_cap = min(max_rows, cap if _row_cap is None else int(_row_cap))
    blk_cap = min(dims["NECON"],
                  BLK_CAP if _blk_cap is None else int(_blk_cap))
    d = dict(NQ=nq, NV=nv, NU=nu, NBODY=m.nbody, NJNT=m.njnt, H=horizon,
             P=num_nodes, NAUX=naux, NAUXS=naux_static, NTERM=nterm, NR=nr,
             N_NEWTON=n_newton,
             N_LS=n_ls, MODE=mode, CONE=int(c["cone"]), TEAM=team,
             ROWCAP=row_cap, BLKCAP=blk_cap,
             PROFILE=int(_profile), CTRL=int(feedback),
             **dims)
    out = {f"LR_{k}": v for k, v in d.items()}
    out["RESIDUAL_HEADER"] = header   # stringified by the source
    return out, blob

  def library():
    if state["lib"] is None:
      defs, blob = defines()
      lib = _build.load("lane_rollout.cu", defs)
      lib.lane_tables_size.restype = ctypes.c_int
      lib.lane_set_tables.restype = ctypes.c_int
      lib.lane_set_tables.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_void_p]
      lib.lane_rollout.restype = ctypes.c_int
      lib.lane_rollout.argtypes = [ctypes.c_void_p] * 8 + [
          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
      for fn in ("lane_team", "lane_ctab_in_shared", "lane_workspace_floats",
                 "lane_smem_bytes"):
        getattr(lib, fn).restype = ctypes.c_int
      lib.lane_smem_bytes.argtypes = [ctypes.c_int]
      if lib.lane_tables_size() != len(blob):
        raise RuntimeError(
            f"constant-table layout mismatch: kernel expects "
            f"{lib.lane_tables_size()} bytes, wrapper packed {len(blob)}")
      state["lib"], state["blob"] = lib, blob
    return state["lib"]

  def _check(x, rows, k, name):
    if x.device.type != "cuda" or x.dtype != torch.float32 or \
        tuple(x.shape) != (rows, k) or not x.is_contiguous():
      raise ValueError(
          f"{name}: expected a contiguous float32 CUDA tensor of shape "
          f"({rows}, {k}), got {x.dtype} {tuple(x.shape)} on {x.device}"
          f"{'' if x.is_contiguous() else ' (not contiguous)'}")

  def rollout_cuda(qpos0, qvel0, values, aux=None, table=None):
    global launch_count
    k = qpos0.shape[-1]
    dev = qpos0.device
    _check(qpos0, nq, k, "qpos0")
    _check(qvel0, nv, k, "qvel0")
    if feedback:
      _check(values, 2, k, "values")
      if table is None or table.device != dev or \
          table.dtype != torch.float32 or \
          tuple(table.shape) != (horizon * stride,) or \
          not table.is_contiguous():
        raise ValueError(
            "table: expected a contiguous float32 tensor of shape "
            f"({horizon * stride},) on {dev}")
    elif nu == 0:
      values = torch.zeros((1, k), dtype=torch.float32, device=dev)
    else:
      _check(values, num_nodes * nu, k, "values")
    if residual is not None:
      if aux is None:
        raise ValueError("aux rows are required with an in-kernel residual")
      _check(aux, max(naux_kernel, 1), k, "aux")
    else:
      aux = values  # never read
    if not feedback:
      table = values  # never read
    lib = library()
    f32 = dict(dtype=torch.float32, device=dev)
    team = lib.lane_team()
    tpb = int(_teams_per_block) if _teams_per_block is not None else \
        teams_per_block(k, team, lib.lane_smem_bytes,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    # the global workspace for active rows past the shared-memory caps
    ws_key = (str(dev), k)
    if ws_key not in state["ws"]:
      state["ws"][ws_key] = torch.empty(
          max(lib.lane_workspace_floats() * k, 1), **f32)
    ws = state["ws"][ws_key]
    if mode == MODE_STATES:
      out0 = torch.empty((horizon, nq + nv + nr, k), **f32)
      out1 = out0
    elif mode == MODE_RESIDUALS:
      out0 = torch.empty((horizon, nr, k), **f32)
      out1 = torch.empty((nq + nv, k), **f32)
    else:
      out0 = torch.empty((nterm, k), **f32)
      out1 = torch.empty((nq + nv, k), **f32)
    with torch.cuda.device(dev):
      stream = torch.cuda.current_stream().cuda_stream
      # the library's constant tables may hold another model with the
      # same dimensions: (re)load ours whenever we are not the last user
      if getattr(lib, "tables_owner", None) is not state:
        err = lib.lane_set_tables(state["blob"], len(state["blob"]), stream)
        if err != 0:
          raise RuntimeError(f"lane_set_tables failed: CUDA error {err}")
        lib.tables_owner = state
      err = lib.lane_rollout(qpos0.data_ptr(), qvel0.data_ptr(),
                             values.data_ptr(), aux.data_ptr(),
                             table.data_ptr(), out0.data_ptr(),
                             out1.data_ptr(), ws.data_ptr(), k, tpb, stream)
    if err != 0:
      raise RuntimeError(f"lane_rollout launch failed: CUDA error {err}")
    launch_count += 1
    return out0 if mode == MODE_STATES else (out0, out1)

  def rollout(qpos0, qvel0, values, aux=None, table=None):
    if feedback and table is None:
      raise ValueError("feedback=True needs the per-step table")
    if qpos0.device.type == "cuda":
      return rollout_cuda(qpos0, qvel0, values, aux, table)
    return rollout_plain(qpos0, qvel0, values, aux, table)

  def step_array(qpos, qvel, ctrl, t=0, aux=None):
    """One physics step as plain PyTorch on (dim, K) tensors."""
    qp = [qpos[i] for i in range(nq)]
    qv = [qvel[i] for i in range(nv)]
    ct = [ctrl[i] for i in range(nu)]
    ax = None if aux is None else [aux[i] for i in range(aux.shape[0])]
    axd = None if aux is None else (lambda i: aux[i])
    qpn, qvn, res = step_body(qp, qv, ct, t, ax, aux_dyn=axd)
    out = (torch.stack(qpn), torch.stack(qvn))
    return out + ((torch.stack(res),) if res is not None else ())

  def residual_array(qpos, qvel, ctrl, t=0, aux=None):
    """Residual rows as plain PyTorch on (dim, K) tensors, computing only
    the derived quantities the residual needs."""
    if residual_fn is None:
      raise ValueError("residual_array requires the kernel to be built "
                       "with a residual (this one was not)")
    qp = [qpos[i] for i in range(nq)]
    qv = [qvel[i] for i in range(nv)]
    ct = [ctrl[i] for i in range(nu)]
    ax = None if aux is None else [aux[i] for i in range(aux.shape[0])]
    axd = None if aux is None else (lambda i: aux[i])
    _, _, res = step_body(qp, qv, ct, t, ax, derived_only=True,
                          aux_dyn=axd)
    return torch.stack(res)

  rollout.plain = rollout_plain
  rollout.step_array = step_array
  rollout.residual_array = residual_array
  rollout.build_defines = lambda: defines()[0]
  rollout.library = library
  rollout.tables = lambda: defines()[1]
  rollout.mode = mode
  rollout.stride = stride
  rollout.feedback_ctrl = feedback_ctrl
  return rollout
