"""Swimmer task: 6-link planar swimmer reaching a target in viscous fluid.

Residuals Control(5) + nose-to-target XY distance; the host transition
teleports the target when reached. Exercises the fluid (viscosity /
density) passive-force model.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.tasks import base

NOSE_BODY = 1


class Swimmer(base.Task):
  """Swim the nose to the target."""

  name = "Swimmer"
  asset = "swimmer.npz"

  def residual(self, m, d, params: torch.Tensor) -> torch.Tensor:
    nose = d.xpos[NOSE_BODY, :2]
    target = d.mocap_pos[0, :2]
    return torch.cat([d.ctrl, nose - target])

  def lane_residual_spec(self):
    """In-kernel residual for ops/step_lane.py: ctrl + nose-to-target
    error; the target rides aux (frozen per plan like the pipeline's
    d0.mocap_pos)."""
    nu = self.plan_model.nu

    def fn(ctx):
      xpos, aux = ctx["xpos"], ctx["aux"]
      return list(ctx["ctrl"]) + [xpos[NOSE_BODY][0] - aux[0],
                                  xpos[NOSE_BODY][1] - aux[1]]

    def make_aux(d0, params):
      return d0.mocap_pos[0, :2]

    consts = [("nose_body", np.int32, np.array([NOSE_BODY]))]
    return dict(dim=nu + 2, naux=2, fn=fn, make_aux=make_aux,
                header="residual_swimmer.cuh", consts=consts)

  def transition(self, d, rng: np.random.Generator):
    """Teleport the target when the nose reaches it (host-side; the new
    target comes from the caller's generator)."""
    nose = d.xpos[NOSE_BODY, :2].cpu().numpy() if d.xpos is not None \
        else np.zeros(2)
    target = d.mocap_pos[0, :2].cpu().numpy()
    if np.linalg.norm(target - nose) < 0.04:
      mocap = d.mocap_pos.clone()
      mocap[0, :2] = torch.as_tensor(
          rng.uniform(-0.8, 0.8, size=2).astype(np.float32)).to(mocap.device)
      return d.replace(mocap_pos=mocap)
    return d
