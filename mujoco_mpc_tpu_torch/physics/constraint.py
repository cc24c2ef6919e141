"""Soft-constraint assembly and solver: joint-limit rows and pyramidal
contact rows.

A FIXED-SIZE constraint system: every side of every limited joint and every
selected candidate contact always has rows; rows whose gate (the gating
distance, `efc_gate`) is non-negative get zero stiffness (D = 0), so
inactive rows are no-ops and all shapes are static. The contact rows follow
the joint-limit rows, as in the JAX package's make_constraint.

Contacts are pyramidal: 2*(condim-1) rows a contact, J = Jn +/- mu_a J_a
for each friction axis a (tangents, then torsion and rolling from the
rotational relative Jacobian); all rows of a contact share diag = invw *
2 mu0^2 (1 + mu0^2) / impratio; condim-1 contacts become two pure normal
rows with diag 2 invw; rows of axes a contact's condim does not reach are
gated off. When the candidates outnumber `opt.max_contact_points`, only
the deepest (top-k over -gap) get rows.

The solver minimizes the primal objective

    0.5 (a - a0)^T M (a - a0) + sum_i 0.5 D_i [ (Ja - aref)_i^- ]^2

with one-sided quadratic costs, by a fixed number of Newton iterations with
a safeguarded exact 1-D line search. Everything is `where`-based, so the
solve is differentiable as written (forward-mode AD passes through it).

Elliptic cones, equality, tendon-limit and friction-loss rows and the
noslip post-solver of the JAX package's physics/constraint.py are not
ported yet; physics/forward.py refuses models that need them.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import collision as coll
from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.physics.model import (CONE_ELLIPTIC, Contact, Data,
                                                Model)

_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """Constraint impedance d(r) (mju_makeImpedance semantics)."""
  dmin, dmax, width, mid, power = (solimp[..., 0], solimp[..., 1],
                                   solimp[..., 2], solimp[..., 3],
                                   solimp[..., 4])
  x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=_MINVAL), 0.0, 1.0)
  mid = torch.clamp(mid, _MINIMP, _MAXIMP)
  power = torch.clamp(power, min=1.0)
  a = 1.0 / torch.pow(mid, power - 1.0)
  b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
  y = torch.where(x <= mid, a * torch.pow(x, power),
                  1.0 - b * torch.pow(1.0 - x, power))
  return torch.clamp(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def _kbi(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor,
         jv: torch.Tensor):
  """Reference acceleration aref and impedance d for constraint rows."""
  imp = _impedance(solimp, pos)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  # standard (positive solref): spring-damper in units of constraint pos
  b_std = 2.0 / torch.clamp(dmax * timeconst, min=_MINVAL)
  k_std = 1.0 / torch.clamp(
      dmax * dmax * timeconst * timeconst * dampratio * dampratio,
      min=_MINVAL)
  # direct (non-positive solref): (-stiffness, -damping)
  b_dir = -solref[..., 1] / torch.clamp(dmax, min=_MINVAL)
  k_dir = -solref[..., 0] / torch.clamp(dmax * dmax, min=_MINVAL)
  use_std = (timeconst > 0) & (dampratio > 0)
  b = torch.where(use_std, b_std, b_dir)
  k = torch.where(use_std, k_std, k_dir)
  return -b * jv - k * imp * pos, imp


def _limit_rows(m: Model, d: Data):
  """Joint-limit rows for limited hinge/slide joints, two per joint (lower:
  dist = qpos - range0, J = +e; upper: dist = range1 - qpos, J = -e):
  (J, pos, solref, solimp, diag) or None."""
  t = m.dev
  if t["lim_J"].shape[0] == 0:
    return None
  dist = t["lim_sign"] * (d.qpos[t["lim_qadr"]] - t["lim_range"])
  return (t["lim_J"], dist - t["lim_margin"], t["lim_solref"],
          t["lim_solimp"], t["lim_diag"])


def contact_layout(m: Model) -> tuple:
  """Static contact-block layout (k, namax, rows_per_contact): k selected
  contacts, namax friction axes built a contact (max condim - 1, at least
  2), rows a contact (pyramidal 2 namax, elliptic 1 + namax)."""
  cp = m.collision_pairs
  if cp is None or cp.ncon == 0:
    return 0, 0, 0
  k = min(m.opt.max_contact_points, cp.ncon)
  namax = max(2, int(cp.con_condim.max()) - 1)
  nrow = (1 + namax) if m.opt.cone == CONE_ELLIPTIC else 2 * namax
  return k, namax, nrow


def _body_jac(m: Model, d: Data, body: torch.Tensor, point: torch.Tensor):
  """Translational Jacobians (k, 3, nv) of world points on bodies."""
  ref = d.subtree_com[m.dev["body_rootid"][body]]            # (k, 3)
  offset = (point - ref)[:, None, :]                         # (k, 1, 3)
  jac = d.cdof[None, :, 3:] + mm.cross(d.cdof[None, :, :3], offset)
  mask = m.dev["body_dof_mask"][body][:, :, None]            # (k, nv, 1)
  return (jac * mask).transpose(1, 2)


def _rot_jac(m: Model, d: Data, body: torch.Tensor):
  """Rotational Jacobians (k, 3, nv) of bodies."""
  mask = m.dev["body_dof_mask"][body][:, :, None]
  return (d.cdof[None, :, :3] * mask).transpose(1, 2)


def _contact_rows(m: Model, d: Data):
  """(Contact, (J, pos, solref, solimp, gate, diag)) of the pyramidal
  contact rows, or (None, None) for a model without candidate contacts."""
  cp = m.collision_pairs
  if cp is None or cp.ncon == 0:
    return None, None
  if m.opt.cone == CONE_ELLIPTIC:
    raise NotImplementedError(
        "elliptic friction cones are not ported to the pipeline physics "
        "(ROADMAP queue 1 item 4)")
  t = m.dev
  dist, pos, n = coll.collide(m, d)
  frame = coll.make_contact_frame(n)                         # (ncon, 3, 3)
  gap = dist - t["con_includemargin"]      # gating distance: < 0 is active
  k, namax, nrow = contact_layout(m)
  names = ("con_friction", "con_solref", "con_solimp", "con_includemargin",
           "con_condim", "con_body1", "con_body2", "con_geom1", "con_geom2",
           "con_invw", "con_row_ok", "con_c1_axis0", "con_is_c1")
  if k < cp.ncon:
    # the k deepest candidates (sorted, as the JAX package's top_k)
    _, sel = torch.topk(-gap, k)
    dist, pos, frame, gap = dist[sel], pos[sel], frame[sel], gap[sel]
    c = {name: t[name][sel] for name in names}
  else:
    c = {name: t[name] for name in names}
  friction = c["con_friction"]
  mu0 = friction[:, 0]
  impratio = torch.clamp(m.opt.impratio, min=_MINVAL)
  contact = Contact(
      dist=dist, pos=pos, frame=frame, includemargin=c["con_includemargin"],
      friction=friction, solref=c["con_solref"], solimp=c["con_solimp"],
      geom1_id=c["con_geom1"], geom2_id=c["con_geom2"], body1=c["con_body1"],
      body2=c["con_body2"], dim=c["con_condim"],
      mu_eff=mu0 / torch.sqrt(impratio), cone=int(m.opt.cone), namax=namax)

  b1, b2 = c["con_body1"], c["con_body2"]
  jrel = _body_jac(m, d, b2, pos) - _body_jac(m, d, b1, pos)
  jc = frame @ jrel                                          # (k, 3, nv)
  # friction-axis Jacobians: the tangents, then (condim > 3) torsion and
  # rolling from the rotational relative Jacobian
  if namax > 2:
    jr = frame @ (_rot_jac(m, d, b2) - _rot_jac(m, d, b1))
    axes_j = torch.cat([jc[:, 1:3], jr[:, 0:1], jr[:, 1:3]], dim=1)[:, :namax]
  else:
    axes_j = jc[:, 1:3]                                      # (k, 2, nv)

  # condim-1 contacts ride axis 0 as two pure normal rows (mu = 0)
  mu_row = torch.where(c["con_c1_axis0"], torch.zeros_like(mu0[:, None]),
                       friction[:, :namax])
  jn = jc[:, 0:1, :]
  plus = jn + mu_row[..., None] * axes_j                     # (k, namax, nv)
  minus = jn - mu_row[..., None] * axes_j
  rows_j = torch.stack([plus, minus], dim=2).reshape(k * nrow, m.nv)
  # all rows of a contact share the friction[0]-based diag, stiffened by
  # impratio; frictionless contacts are not
  invw = c["con_invw"]
  diag_c = torch.where(c["con_is_c1"], 2.0 * invw,
                       invw * 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) / impratio)
  gate = torch.where(c["con_row_ok"], gap[:, None], torch.ones_like(
      gap[:, None]))
  gate = torch.stack([gate, gate], dim=2).reshape(k * nrow)

  def per_row(x):
    return x[:, None].expand(k, nrow, *x.shape[1:]).reshape(
        k * nrow, *x.shape[1:])

  return contact, (rows_j, per_row(gap), per_row(c["con_solref"]),
                   per_row(c["con_solimp"]), gate, per_row(diag_c))


def make_constraint(m: Model, d: Data) -> Data:
  """Assemble fixed-size efc_{J, pos, ...} (positions stage): the limit
  rows, then the contact rows."""
  dtype, device = d.qpos.dtype, d.qpos.device
  parts = []
  lim = _limit_rows(m, d)
  if lim is not None:
    lj, lp, lr, li, ld = lim
    parts.append((lj, lp, lr, li, lp, ld))     # a limit is active iff pos < 0
  contact, con = _contact_rows(m, d)
  if con is not None:
    parts.append(con)
  if not parts:
    z = torch.zeros((0,), dtype=dtype, device=device)
    return d.replace(
        efc_J=torch.zeros((0, m.nv), dtype=dtype, device=device),
        efc_pos=z, efc_solref=z.reshape(0, 2), efc_solimp=z.reshape(0, 5),
        efc_diag=z, efc_gate=z, efc_eq=z, efc_D=z, efc_aref=z)
  if len(parts) == 1:
    j, pos, ref, imp, gate, diag = parts[0]
  else:
    j, pos, ref, imp, gate, diag = (torch.cat(x) for x in zip(*parts))
  return d.replace(contact=contact, efc_J=j, efc_pos=pos, efc_solref=ref,
                   efc_solimp=imp, efc_gate=gate, efc_diag=diag,
                   efc_eq=torch.zeros_like(pos))


def reference_constraint(m: Model, d: Data) -> Data:
  """Velocity stage: aref and D for all rows. A row is active iff its gate
  is negative."""
  if d.efc_J.shape[0] == 0:
    return d
  jv = d.efc_J @ d.qvel
  aref, imp = _kbi(d.efc_solref, d.efc_solimp, d.efc_pos, jv)
  r = torch.clamp((1.0 - imp) / torch.clamp(imp, min=_MINVAL) *
                  torch.clamp(d.efc_diag, min=_MINVAL), min=_MINVAL)
  gate = (d.efc_gate < 0).to(r.dtype)
  return d.replace(efc_D=gate / r, efc_aref=aref)


def efc_force_at(d: Data, qacc: torch.Tensor) -> torch.Tensor:
  """Explicit constraint force at a GIVEN acceleration: inequality rows
  push only while jar = J qacc - aref < 0."""
  jar = d.efc_J @ qacc - d.efc_aref
  return -((jar < 0).to(jar.dtype) * d.efc_D * jar)


def solve(m: Model, d: Data) -> Data:
  """Primal Newton solve for the constrained qacc."""
  iterations = m.opt.iterations
  ls_iterations = m.opt.ls_iterations
  dtype, device = d.qpos.dtype, d.qpos.device
  nv = m.nv
  if d.efc_J is None or d.efc_J.shape[0] == 0:
    return d.replace(
        qacc=d.qacc_smooth,
        qfrc_constraint=torch.zeros((nv,), dtype=dtype, device=device),
        efc_force=torch.zeros((0,), dtype=dtype, device=device))

  mass, j, dvec, aref, a0 = d.qM, d.efc_J, d.efc_D, d.efc_aref, d.qacc_smooth
  eye = torch.eye(nv, dtype=dtype, device=device)
  one = torch.ones((), dtype=dtype, device=device)
  zero = torch.zeros((), dtype=dtype, device=device)

  def grad_weight(jar):
    """Cost gradient g(jar) and diagonal curvature h(jar) of the one-sided
    quadratic rows."""
    h = (jar < 0).to(dtype) * dvec
    return h * jar, h

  def newton_step(a):
    jar = j @ a - aref
    g, hw = grad_weight(jar)
    ma = mass @ (a - a0)
    grad = ma + j.transpose(-1, -2) @ g
    h = mass + (j.transpose(-1, -2) * hw) @ j + 1e-8 * eye
    p = -S.spd_solve(m, h, grad)

    # Safeguarded exact line search on the piecewise-quadratic phi(t). phi
    # is CONVEX, so phi'(t) is monotone nondecreasing: bracket the root of
    # phi' (expansion by 4x), then Newton steps clipped into the bracket
    # with a regula-falsi fallback.
    jp = j @ p
    pmp = p @ (mass @ p)
    pma = p @ ma

    def dphi_at(t):
      gt, ht = grad_weight(jar + t * jp)
      return (pma + t * pmp + torch.sum(gt * jp),
              pmp + torch.sum(ht * jp * jp))

    hi, d_hi = one, dphi_at(one)[0]
    for _ in range(5):
      need = d_hi < 0.0
      hi2 = torch.where(need, hi * 4.0, hi)
      d_hi = torch.where(need, dphi_at(hi2)[0], d_hi)
      hi = hi2
    lo, dlo, dhi = zero, dphi_at(zero)[0], d_hi
    t = torch.minimum(one, hi)
    for _ in range(ls_iterations):
      dphi, ddphi = dphi_at(t)
      neg = dphi < 0.0
      lo = torch.where(neg, t, lo)
      dlo = torch.where(neg, dphi, dlo)
      hi = torch.where(neg, hi, t)
      dhi = torch.where(neg, dhi, dphi)
      t_n = t - dphi / torch.clamp(ddphi, min=_MINVAL)
      denom = dhi - dlo
      t_s = lo - dlo * (hi - lo) / torch.where(
          torch.abs(denom) < _MINVAL, one, denom)
      t_s = torch.minimum(torch.maximum(t_s, lo), hi)
      inb = (t_n > lo) & (t_n < hi)
      t = torch.where(inb, t_n, t_s)
    t = torch.minimum(torch.maximum(t, zero), hi)
    return a + t * p

  a = a0
  for _ in range(iterations):
    a = newton_step(a)

  efc_force = efc_force_at(d, a)
  qfrc_constraint = j.transpose(-1, -2) @ efc_force
  # recompute the final qacc consistently:
  # M qacc = qfrc_smooth + qfrc_constraint
  qacc = S.solve_m(m, d, d.qfrc_smooth + qfrc_constraint)
  d = d.replace(qacc=qacc, qfrc_constraint=qfrc_constraint,
                efc_force=efc_force)
  if d.contact is not None:
    # contact-frame forces from the pyramidal tail rows (a0+, a0-, a1+, ...):
    # f_n = sum(lam), f_ti = mu_i (lam_i+ - lam_i-)
    k, namax = d.contact.dist.shape[0], d.contact.namax
    lam = efc_force[efc_force.shape[0] - 2 * namax * k:].reshape(k, namax, 2)
    f_n = torch.sum(lam, dim=(1, 2))
    f_t = d.contact.friction[:, :2] * (lam[:, :2, 0] - lam[:, :2, 1])
    d = d.replace(contact=d.contact.replace(
        force=torch.cat([f_n[:, None], f_t], dim=1)))
  return d
