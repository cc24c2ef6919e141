"""Cartpole swing-up task (residuals Vertical / Centered / Velocity /
Control)."""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.tasks import base


class Cartpole(base.Task):
  """Swing the pole up and center the cart."""

  name = "Cartpole"
  asset = "cartpole.npz"

  def residual_from_rollout(self, states: torch.Tensor,
                            ctrls: torch.Tensor, times: torch.Tensor,
                            params: torch.Tensor) -> torch.Tensor:
    """Lane scoring hook (ops/sampling_lane.py): the residual needs only
    qpos/qvel/ctrl, so it maps directly off the raw (H, nq+nv, K) state
    block -> (H, 4, K)."""
    goal = params[0]
    return torch.stack([
        torch.cos(states[:, 1]) - 1.0,   # Vertical
        states[:, 0] - goal,             # Centered
        states[:, 3],                    # Velocity (qvel of pole)
        ctrls[:, 0],                     # Control
    ], dim=1)
