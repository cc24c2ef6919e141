"""State packing and divergence test shared by the planners' rollouts.

The batched `rollout` / `noisy_rollout` of the JAX package's rollout.py
arrive with the agent loop; the derivative planners need only the pieces
below.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics.model import Data, Model

MAX_RETURN_VALUE = 1e6

# the TRUE dynamic state of a rollout: everything else in Data is derived
# and recomputed every step
_CARRY_FIELDS = ("qpos", "qvel", "act", "ctrl", "time", "mocap_pos",
                 "mocap_quat", "userdata", "qfrc_applied", "xfrc_applied")


def pack_state(d: Data) -> torch.Tensor:
  """[qpos, qvel, act] packing."""
  return torch.cat([d.qpos, d.qvel, d.act])


def slim_carry(d: Data) -> dict:
  return {f: getattr(d, f) for f in _CARRY_FIELDS}


def from_carry(carry: dict) -> Data:
  return Data(**carry)


def set_state(m: Model, d: Data, state: torch.Tensor) -> Data:
  nq, nv, na = m.nq, m.nv, m.na
  return d.replace(qpos=state[:nq], qvel=state[nq:nq + nv],
                   act=state[nq + nv:nq + nv + na])


def _diverged(d: Data) -> torch.Tensor:
  bad = ~torch.isfinite(d.qpos).all() | ~torch.isfinite(d.qvel).all()
  big = (torch.abs(d.qvel).amax() > 1e7) | (torch.abs(d.qpos).amax() > 1e7)
  return bad | big
