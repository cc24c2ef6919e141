"""Forward dynamics pipeline and integrators (mj_forward / mj_step
semantics) for contact-free models.

Pure functions `forward(m, d) -> d` and `step(m, d) -> d` on unbatched
tensors, written so that `torch.func.vmap` and `torch.func.jacfwd` trace
them: batches and derivatives come from those transforms.

Ported: kinematics, com quantities, mass matrix, RNE bias, springs,
dampers and the inertia-box fluid model, joint transmissions with
fixed/affine gain and bias, joint-limit rows with the Newton solve, the
Euler (implicit joint damping) and RK4 integrators. A model that needs
anything else — contacts, equality or tendon constraints, friction loss,
muscles, tendon or site transmissions, activation states, the implicit
integrators, noslip — raises NotImplementedError naming what is missing
(`check_supported`); it is never stepped wrongly.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics import constraint as C
from mujoco_mpc_tpu_torch.physics import kinematics as K
from mujoco_mpc_tpu_torch.physics import math as mm
from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.physics.model import (BALL, DYN_NONE, EULER, FREE,
                                                GAIN_MUSCLE, BIAS_MUSCLE,
                                                RK4, TRN_JOINT, Data, Model)


def unsupported(m: Model) -> list:
  """What `m` needs that the pipeline physics does not have yet."""
  missing = []
  if m.collision_pairs is not None and m.collision_pairs.ncon > 0:
    missing.append(f"contacts ({m.collision_pairs.ncon} candidate contacts)")
  if m.neq:
    missing.append(f"equality constraints (neq={m.neq})")
  if m.ntendon:
    missing.append(f"tendons (ntendon={m.ntendon})")
  if m.dev["has_frictionloss"]:
    missing.append("dof friction loss")
  if m.na or np.any(np.asarray(m.actuator_dyntype) != DYN_NONE):
    missing.append(f"actuator activation states (na={m.na})")
  if np.any(np.asarray(m.actuator_gaintype) == GAIN_MUSCLE) or \
      np.any(np.asarray(m.actuator_biastype) == BIAS_MUSCLE):
    missing.append("muscle actuators")
  if np.any(np.asarray(m.actuator_trntype) != TRN_JOINT):
    missing.append("tendon / site / slider-crank transmissions")
  if m.opt.integrator not in (EULER, RK4):
    missing.append(f"integrator {m.opt.integrator} (implicit / "
                   "implicitfast)")
  if m.opt.noslip_iterations > 0:
    missing.append("the noslip post-solver")
  return missing


def check_supported(m: Model) -> None:
  missing = unsupported(m)
  if missing:
    raise NotImplementedError(
        "the pipeline physics is ported for contact-free models only; "
        "this model needs: " + "; ".join(missing))


def fwd_position(m: Model, d: Data) -> Data:
  d = K.kinematics(m, d)
  d = K.com_pos(m, d)
  d = S.crb(m, d)
  d = S.factor_m(m, d)
  return C.make_constraint(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  d = K.com_vel(m, d)
  d = S.rne(m, d)
  d = S.passive(m, d)
  return C.reference_constraint(m, d)


def fwd_actuation(m: Model, d: Data) -> Data:
  return S.actuation(m, d)


def fwd_acceleration(m: Model, d: Data) -> Data:
  """Smooth acceleration: qacc_smooth = M^-1 qfrc_smooth. xfrc_applied
  rows are (force[3], torque[3]) at the body com."""
  xfrc_q = S.apply_ft(m, d, d.xfrc_applied[:, :3], d.xfrc_applied[:, 3:],
                      d.xipos)
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator +
                 d.qfrc_applied + xfrc_q)
  return d.replace(qfrc_smooth=qfrc_smooth,
                   qacc_smooth=S.solve_m(m, d, qfrc_smooth))


def forward(m: Model, d: Data) -> Data:
  check_supported(m)
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  return C.solve(m, d)


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   dt) -> torch.Tensor:
  """mj_integratePos: scalar joints add dt * qvel, quaternions integrate in
  the local frame."""
  if not np.any((m.jnt_type == FREE) | (m.jnt_type == BALL)):
    return qpos + dt * qvel
  parts = []
  for j in range(m.njnt):
    jtype = int(m.jnt_type[j])
    qa, da = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if jtype == FREE:
      parts.append(qpos[qa:qa + 3] + dt * qvel[da:da + 3])
      parts.append(mm.quat_integrate(
          mm.normalize_quat(qpos[qa + 3:qa + 7]), qvel[da + 3:da + 6], dt))
    elif jtype == BALL:
      parts.append(mm.quat_integrate(
          mm.normalize_quat(qpos[qa:qa + 4]), qvel[da:da + 3], dt))
    else:
      parts.append(qpos[qa:qa + 1] + dt * qvel[da:da + 1])
  return torch.cat(parts) if parts else qpos


def _advance(m: Model, d: Data, qacc: torch.Tensor, act_dot: torch.Tensor,
             qvel_next=None) -> Data:
  dt = m.opt.timestep
  act = d.act + dt * act_dot
  qvel = d.qvel + dt * qacc if qvel_next is None else qvel_next
  qpos = _integrate_pos(m, d.qpos, qvel, dt)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + dt)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (mj_Euler)."""
  if m.dev["has_damping"]:
    # (M + h*diag(damping)) qacc' = qfrc_smooth + qfrc_constraint
    mh = d.qM + m.opt.timestep * torch.diag(m.dof_damping)
    qacc = S.chol_solve(S.cholesky(mh),
                        d.qfrc_smooth + d.qfrc_constraint)
  else:
    qacc = d.qacc
  return _advance(m, d, qacc, d.act_dot)


def rk4(m: Model, d: Data) -> Data:
  """4th-order Runge-Kutta (mj_RungeKutta)."""
  dt = m.opt.timestep
  a = (0.5, 0.5, 1.0)
  b = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
  qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
  # stage derivatives: (qvel, qacc, act_dot)
  ks = [(d.qvel, d.qacc, d.act_dot)]
  for i in range(3):
    qv, qa, ad = ks[-1]
    di = d.replace(qpos=_integrate_pos(m, qpos0, qv, a[i] * dt),
                   qvel=qvel0 + a[i] * dt * qa, act=act0 + a[i] * dt * ad)
    di = forward(m, di)
    ks.append((di.qvel, di.qacc, di.act_dot))
  qvel_avg = sum(b[i] * ks[i][0] for i in range(4))
  qacc_avg = sum(b[i] * ks[i][1] for i in range(4))
  act_avg = sum(b[i] * ks[i][2] for i in range(4))
  return d.replace(qpos=_integrate_pos(m, qpos0, qvel_avg, dt),
                   qvel=qvel0 + dt * qacc_avg, act=act0 + dt * act_avg,
                   time=d.time + dt)


def integrate(m: Model, d: Data) -> Data:
  """Integration stage of mj_step, assuming forward() already ran on d.

  Split out so rollouts can read time-consistent derived quantities
  (residuals on the pre-integration state) before advancing the state."""
  if m.opt.integrator == RK4:
    return rk4(m, d)
  if m.opt.integrator != EULER:
    check_supported(m)
  return euler(m, d)


def step(m: Model, d: Data) -> Data:
  """mj_step: forward dynamics + integration."""
  return integrate(m, forward(m, d))
