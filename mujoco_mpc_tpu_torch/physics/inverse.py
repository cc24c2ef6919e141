"""Inverse dynamics: the applied generalized force that gives (q, v, a).

mj_inverse semantics, as the JAX package's physics/inverse.py:

    qfrc_inverse = M(q) a + bias(q, v) - passive(q, v)
                   - J(q)^T f_constraint(q, v, a)

The soft convex constraint model makes f_constraint an explicit function of
the given acceleration (constraint.efc_force_at), so inverse dynamics needs
no iterative solve. The Direct optimizer's force residual reads it.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import constraint as C
from mujoco_mpc_tpu_torch.physics import kinematics as K
from mujoco_mpc_tpu_torch.physics import smooth as S
from mujoco_mpc_tpu_torch.physics.forward import check_supported
from mujoco_mpc_tpu_torch.physics.model import Data, Model


def inv_stages(m: Model, d: Data) -> Data:
  """The position and velocity stages shared with forward dynamics (all
  but actuation, acceleration and the solve)."""
  check_supported(m)
  d = K.kinematics(m, d)
  d = K.com_pos(m, d)
  d = S.crb(m, d)
  d = C.make_constraint(m, d)
  d = K.com_vel(m, d)
  d = S.rne(m, d)
  d = S.passive(m, d)
  return C.reference_constraint(m, d)


def force_at(d: Data, qacc: torch.Tensor,
             smooth_only: bool = False) -> torch.Tensor:
  """The inverse force at `qacc` for a Data past `inv_stages` (or past the
  position and velocity stages of forward dynamics)."""
  tau = d.qM @ qacc + d.qfrc_bias - d.qfrc_passive
  if smooth_only or d.efc_J is None or d.efc_J.shape[0] == 0:
    return tau
  return tau - d.efc_J.transpose(0, 1) @ C.efc_force_at(d, qacc)


def inverse(m: Model, d: Data, qacc: torch.Tensor,
            smooth_only: bool = False) -> torch.Tensor:
  """Generalized applied force producing qacc at (qpos, qvel).
  smooth_only=True leaves the constraint force out (M a + bias -
  passive)."""
  return force_at(inv_stages(m, d), qacc, smooth_only)
