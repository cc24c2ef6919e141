"""Soft-constraint assembly and solver, restricted to joint-limit rows.

A FIXED-SIZE constraint system: every side of every limited joint always
has a row; rows whose gating distance is non-negative get zero stiffness
(D = 0), so inactive rows are no-ops and all shapes are static.

The solver minimizes the primal objective

    0.5 (a - a0)^T M (a - a0) + sum_i 0.5 D_i [ (Ja - aref)_i^- ]^2

with one-sided quadratic costs, by a fixed number of Newton iterations with
a safeguarded exact 1-D line search. Everything is `where`-based, so the
solve is differentiable as written (forward-mode AD passes through it).

Contact rows (pyramidal and elliptic), equality, tendon-limit and
friction-loss rows and the noslip post-solver of the JAX package's
physics/constraint.py are not ported yet; physics/forward.py refuses models
that need them.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.physics.model import Data, Model

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


def make_constraint(m: Model, d: Data) -> Data:
  """Assemble fixed-size efc_{J, pos, ...} (positions stage)."""
  lim = _limit_rows(m, d)
  if lim is None:
    z = torch.zeros((0,), dtype=d.qpos.dtype, device=d.qpos.device)
    return d.replace(
        efc_J=torch.zeros((0, m.nv), dtype=d.qpos.dtype,
                          device=d.qpos.device),
        efc_pos=z, efc_solref=z.reshape(0, 2), efc_solimp=z.reshape(0, 5),
        efc_diag=z, efc_D=z, efc_aref=z)
  lj, lp, lr, li, ld = lim
  return d.replace(efc_J=lj, efc_pos=lp, efc_solref=lr, efc_solimp=li,
                   efc_diag=ld)


def reference_constraint(m: Model, d: Data) -> Data:
  """Velocity stage: aref and D for all rows. A limit row is active iff its
  position is negative."""
  if d.efc_J.shape[0] == 0:
    return d
  jv = d.efc_J @ d.qvel
  aref, imp = _kbi(d.efc_solref, d.efc_solimp, d.efc_pos, jv)
  r = torch.clamp((1.0 - imp) / torch.clamp(imp, min=_MINVAL) *
                  torch.clamp(d.efc_diag, min=_MINVAL), min=_MINVAL)
  gate = (d.efc_pos < 0).to(r.dtype)
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
  return d.replace(qacc=qacc, qfrc_constraint=qfrc_constraint,
                   efc_force=efc_force)
