"""Smooth (unconstrained) dynamics: mass matrix, bias forces, passive forces
(springs, dampers, inertia-box fluid), actuation. Semantics match MuJoCo
mj_crb / mj_rne / mj_passive / mj_fwdActuation, as the JAX package's
physics/smooth.py does.

The mass matrix is dense (nv x nv): robotics nv is small, and the dense
form makes CRB one masked matrix product and the solves Cholesky solves.

Ported for joint transmissions and the fixed/affine gain and bias types
without activation states; joint limits and pyramidal contacts add their
forces through physics/constraint.py. Tendons, site transmissions and
muscles are not ported yet: `check_supported` (physics/forward.py) refuses
such models.
"""

from __future__ import annotations

import math

import torch

from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics.model import Data, Model

# mjtDisableBit values this module honours
DSBL_PASSIVE = 32
DSBL_GRAVITY = 64
DSBL_CLAMPCTRL = 128
DSBL_ACTUATION = 1024

# Model.solve_route values (spd_solve)
SOLVE_LIBRARY = "library"
SOLVE_KERNEL = "kernel"


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body: dense joint-space mass matrix qM."""
  crb_arr = m.dev["subtree_mask"] @ d.cinert                  # (nb, 10)
  f = mm.inert_mul(crb_arr[m.dev["dof_bodyid"]], d.cdof)      # (nv, 6)
  full = f @ d.cdof.transpose(-1, -2)
  lower = full * m.dev["dof_ancestor_mask"]
  qm = lower + lower.transpose(-1, -2) - torch.diag(torch.diagonal(lower))
  return d.replace(qM=qm + torch.diag(m.dof_armature))


def cholesky(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor by the library routine that returns its status
  word instead of checking it: the checking one reads the word back from
  the device on every call (a matrix that is not positive definite gives
  NaNs, which the planners' divergence tests catch)."""
  return torch.linalg.cholesky_ex(a).L


def factor_m(m: Model, d: Data) -> Data:
  """Dense Cholesky factorization of qM (the kernel route factors at every
  solve instead)."""
  if m.solve_route == SOLVE_KERNEL:
    return d
  return d.replace(qLD=cholesky(d.qM))


def chol_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Solve (L L') x = rhs for a vector rhs."""
  y = torch.linalg.solve_triangular(chol, rhs[:, None], upper=False)
  return torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                       upper=True)[:, 0]


def spd_solve(m: Model, a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Solve a x = rhs for an SPD matrix a by the model's route: the library
  Cholesky (differentiable), or the batched Cholesky kernel
  (ops/cholesky.py; under `torch.func.vmap` one launch for the whole batch,
  on CPU tensors its plain version). The kernel clamps the diagonal at 1e-10
  where the library gives NaN for a matrix that is not positive definite."""
  if m.solve_route == SOLVE_KERNEL:
    from mujoco_mpc_tpu_torch.ops import cholesky as lane_cholesky
    return lane_cholesky.spd_solve(a, rhs)
  return chol_solve(cholesky(a), rhs)


def solve_m(m: Model, d: Data, rhs: torch.Tensor) -> torch.Tensor:
  """Solve qM x = rhs (the cached Cholesky factor on the library route)."""
  if m.solve_route == SOLVE_KERNEL:
    return spd_solve(m, d.qM, rhs)
  return chol_solve(d.qLD, rhs)


def rne(m: Model, d: Data) -> Data:
  """Recursive Newton-Euler: qfrc_bias = C(q,v)v + g."""
  gravity = m.opt.gravity
  if (m.opt.disableflags & DSBL_GRAVITY) != 0:
    gravity = torch.zeros_like(gravity)
  cacc_world = torch.cat([torch.zeros_like(gravity), -gravity])
  cacc = cacc_world[None, :] + m.dev["body_dof_mask"] @ (
      d.cdof_dot * d.qvel[:, None])
  iv = mm.inert_mul(d.cinert, d.cvel)
  cfrc = mm.inert_mul(d.cinert, cacc) + mm.force_cross(d.cvel, iv)
  cfrc_tot = m.dev["subtree_mask"] @ (cfrc * m.dev["not_world"])
  qfrc_bias = torch.sum(d.cdof * cfrc_tot[m.dev["dof_bodyid"]], dim=-1)
  return d.replace(qfrc_bias=qfrc_bias)


def _spring_force(m: Model, d: Data) -> torch.Tensor:
  """Joint spring torque: -stiffness * (qpos - qpos_spring) along the
  tangent difference."""
  from mujoco_mpc_tpu_torch.planners import derivatives as _deriv
  dq = _deriv.qpos_diff(m, d.qpos, m.qpos_spring)
  return -m.jnt_stiffness[m.dev["dof_jntid"]] * dq


def _fluid_force(m: Model, d: Data) -> torch.Tensor:
  """Inertia-box fluid model (viscosity / density / wind), mj_passive."""
  box = m.dev["fluid_box"]       # equivalent inertia-box sizes (nb, 3)

  # body spatial velocity at the body com, world frame: cvel is at
  # subtree_com[rootid]; shift to xipos
  ref = d.subtree_com[m.dev["body_rootid"]]
  offset = d.xipos - ref
  ang_w = d.cvel[:, :3]
  lin_w = d.cvel[:, 3:] + mm.cross(ang_w, offset) - m.opt.wind
  rot = d.ximat                                # (nb, 3, 3) world-from-local
  lvel_ang = torch.einsum("bij,bi->bj", rot, ang_w)
  lvel_lin = torch.einsum("bij,bi->bj", rot, lin_w)

  # viscous (linear in velocity)
  diam = torch.mean(box, dim=-1)
  torque = -math.pi * diam[:, None] ** 3 * m.opt.viscosity * lvel_ang
  force = -3.0 * math.pi * diam[:, None] * m.opt.viscosity * lvel_lin

  # density (quadratic drag)
  b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]
  rho = m.opt.density
  force = force - 0.5 * rho * torch.stack([
      b1 * b2 * torch.abs(lvel_lin[:, 0]) * lvel_lin[:, 0],
      b0 * b2 * torch.abs(lvel_lin[:, 1]) * lvel_lin[:, 1],
      b0 * b1 * torch.abs(lvel_lin[:, 2]) * lvel_lin[:, 2],
  ], dim=-1)
  torque = torque - rho * torch.stack([
      b0 * (b1 ** 4 + b2 ** 4) * torch.abs(lvel_ang[:, 0]) * lvel_ang[:, 0],
      b1 * (b0 ** 4 + b2 ** 4) * torch.abs(lvel_ang[:, 1]) * lvel_ang[:, 1],
      b2 * (b0 ** 4 + b1 ** 4) * torch.abs(lvel_ang[:, 2]) * lvel_ang[:, 2],
  ], dim=-1) / 64.0

  # rotate back to world, zero out the world body / massless bodies
  alive = (m.body_mass > 1e-12).to(force.dtype)[:, None]
  force_w = torch.einsum("bij,bj->bi", rot, force) * alive
  torque_w = torch.einsum("bij,bj->bi", rot, torque) * alive
  return apply_ft(m, d, force_w, torque_w, d.xipos)


def apply_ft(m: Model, d: Data, force: torch.Tensor, torque: torch.Tensor,
             point: torch.Tensor) -> torch.Tensor:
  """Map per-body world wrenches applied at `point` to joint space
  (mj_applyFT accumulated over all bodies). force/torque/point: (nbody, 3);
  returns qfrc (nv,)."""
  ref = d.subtree_com[m.dev["body_rootid"]]
  t_ref = torque + mm.cross(point - ref, force)
  fb = torch.cat([t_ref, force], dim=-1)                      # (nb, 6)
  contrib = d.cdof @ fb.transpose(-1, -2)                     # (nv, nb)
  return torch.sum(contrib * m.dev["body_dof_mask"].transpose(-1, -2),
                   dim=-1)


def passive(m: Model, d: Data) -> Data:
  """Spring + damper + fluid passive forces."""
  if (m.opt.disableflags & DSBL_PASSIVE) != 0:
    return d.replace(qfrc_passive=torch.zeros_like(d.qvel))
  qfrc = _spring_force(m, d) - m.dof_damping * d.qvel
  return d.replace(qfrc_passive=qfrc + _fluid_force(m, d))


def transmission(m: Model, d: Data):
  """Actuator lengths (nu,) and moment matrix (nu, nv). For joint
  transmissions the moment is constant: the gear on the joint's dofs."""
  length = d.qpos[m.dev["trn_qadr"]] * m.dev["trn_len_gear"]
  return length, m.dev["trn_moment"]


def actuation(m: Model, d: Data) -> Data:
  """Actuator forces -> qfrc_actuator (mj_fwdActuation) for actuators
  without activation states."""
  like = d.qpos
  nu, nv, na = m.nu, m.nv, m.na
  if nu == 0 or (m.opt.disableflags & DSBL_ACTUATION) != 0:
    z = lambda n: torch.zeros((n,), dtype=like.dtype, device=like.device)
    return d.replace(qfrc_actuator=z(nv), actuator_force=z(nu),
                     actuator_length=z(nu), actuator_velocity=z(nu),
                     act_dot=z(na))

  length, moment = transmission(m, d)
  velocity = moment @ d.qvel

  ctrl = d.ctrl
  if (m.opt.disableflags & DSBL_CLAMPCTRL) == 0:
    clamped = torch.minimum(torch.maximum(ctrl, m.actuator_ctrlrange[:, 0]),
                            m.actuator_ctrlrange[:, 1])
    ctrl = torch.where(m.dev["ctrllimited"], clamped, ctrl)

  prm_g, prm_b = m.actuator_gainprm, m.actuator_biasprm
  gain = torch.where(
      m.dev["gain_fixed"], prm_g[:, 0],
      prm_g[:, 0] + prm_g[:, 1] * length + prm_g[:, 2] * velocity)
  bias = torch.where(
      m.dev["bias_none"], torch.zeros_like(length),
      prm_b[:, 0] + prm_b[:, 1] * length + prm_b[:, 2] * velocity)
  force = gain * ctrl + bias

  fclamped = torch.minimum(torch.maximum(force, m.actuator_forcerange[:, 0]),
                           m.actuator_forcerange[:, 1])
  force = torch.where(m.dev["forcelimited"], fclamped, force)

  return d.replace(
      qfrc_actuator=moment.transpose(-1, -2) @ force, actuator_force=force,
      actuator_length=length, actuator_velocity=velocity,
      act_dot=torch.zeros((na,), dtype=like.dtype, device=like.device),
      ctrl=ctrl)
