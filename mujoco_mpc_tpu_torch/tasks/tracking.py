"""Humanoid motion-capture tracking: follow a keyframed clip.

Linear interpolation between consecutive keyframes at a fixed FPS gives the
reference positions and velocities of six points (head, torso-subtree com,
four foot sites); the residual is joint velocity, control, position and
velocity tracking errors. The default clip is procedural (`make_walk_clip`),
so no data is downloaded. The clip targets vary along the horizon, so the
lane residual reads them from per-step aux rows: `make_aux` interpolates
the clip at the horizon's step times on the device (no host read), the
kernel reads row t*36 + i through `aux_at`.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import lanemath as lm
from mujoco_mpc_tpu_torch.tasks import humanoid
from mujoco_mpc_tpu_torch.tasks.humanoid import site_point, subtree_comvel

FPS = 30.0
# clip rows per step: (pos 6 x 3, vel 6 x 3)
ROWS_PER_STEP = 36


def make_walk_clip(n_frames: int = 120, speed: float = 1.0,
                   height: float = 1.3) -> np.ndarray:
  """Procedural forward-walk clip for {head, torso-com, 4 foot points}.

  Returns (n_frames, 6, 3): head, com, foot L front/back, foot R front/back.
  """
  t = np.arange(n_frames) / FPS
  x = speed * t
  phase = 2 * np.pi * 1.4 * t
  clip = np.zeros((n_frames, 6, 3))
  clip[:, 0] = np.stack([x, 0 * x, height + 0.16 + 0.01 * np.sin(2 * phase)],
                        axis=1)  # head
  clip[:, 1] = np.stack([x, 0 * x, np.full_like(x, height - 0.35)],
                        axis=1)  # com-ish
  step_amp = 0.06
  lz = step_amp * np.maximum(0, np.sin(phase))
  rz = step_amp * np.maximum(0, np.sin(phase + np.pi))
  lx = x + 0.15 * np.sin(phase)
  rx = x + 0.15 * np.sin(phase + np.pi)
  clip[:, 2] = np.stack([lx + 0.09, 0.1 + 0 * x, lz + 0.04], axis=1)
  clip[:, 3] = np.stack([lx - 0.09, 0.1 + 0 * x, lz + 0.04], axis=1)
  clip[:, 4] = np.stack([rx + 0.09, -0.1 + 0 * x, rz + 0.04], axis=1)
  clip[:, 5] = np.stack([rx - 0.09, -0.1 + 0 * x, rz + 0.04], axis=1)
  return clip


def reference(clip: torch.Tensor, time: torch.Tensor):
  """Linearly interpolated clip pose and velocity at `time` (any shape):
  (time.shape + (6, 3)) each, in the clip's dtype, on its device."""
  n = clip.shape[0]
  idx = time * FPS
  i0 = torch.clamp(torch.floor(idx).to(torch.int64), 0, n - 2)
  w1 = torch.clamp(idx - i0.to(idx.dtype), 0.0, 1.0)[..., None, None]
  p0 = clip[i0]
  p1 = clip[i0 + 1]
  pos = (1.0 - w1) * p0 + w1 * p1
  vel = (p1 - p0) * FPS
  return pos, vel


class HumanoidTracking(humanoid.HumanoidStand):
  """Track a motion clip."""

  name = "Humanoid Track"
  asset = "humanoid_track.npz"

  def __init__(self, clip: np.ndarray = None, **kw):
    super().__init__(**kw)
    self.clip = torch.as_tensor(np.asarray(
        clip if clip is not None else make_walk_clip(),
        np.float32)).to(self.device)

  def lane_residual_spec(self, horizon: int = None):
    """In-kernel tracking residual: (nv - 6) + nu + 36 rows. Per-step aux
    rows: `make_aux` packs (pos 18, vel 18) at d0.time + h t as row
    t*36 + i, every row per-step (`naux_static` 0); the device function is
    ops/csrc/residual_tracking.cuh."""
    if horizon is None:
      raise TypeError("the tracking lane spec needs the horizon")
    m = self.plan_model
    nv, nu = m.nv, m.nu
    h = float(m.opt.timestep)
    g = self._lane_geometry()
    torso = self._torso

    def fn(ctx):
      t, aux_dyn = ctx["t"], ctx["aux_dyn"]
      qvel, ctrl = ctx["qvel"], ctx["ctrl"]
      scom, ref, cvel = ctx["subtree_com"], ctx["ref"], ctx["cvel"]
      base = t * ROWS_PER_STEP
      rows = [qvel[i] for i in range(6, nv)]
      rows += list(ctrl)
      def site(b, p):
        sp = site_point(ctx, b, p)
        ang, lin = cvel[b]
        return sp, lm.vadd(lin, lm.vcross(ang, lm.vsub(sp, ref[b])))

      # (position, velocity) of the head, the subtree com, 4 foot sites
      com = (tuple(scom[torso][k] for k in range(3)),
             tuple(subtree_comvel(ctx, g["ids"], g["body_mass"],
                                  g["total_mass"])))
      points = [site(g["head_b"], g["head_p"]), com] + \
          [site(b, p) for b, p in g["feet"]]
      for j, (p, _) in enumerate(points):
        for k in range(3):
          rows.append(p[k] - aux_dyn(base + 3 * j + k))
      for j, (_, v) in enumerate(points):
        for k in range(3):
          rows.append(v[k] - aux_dyn(base + 18 + 3 * j + k))
      return rows

    clip = self.clip
    steps = torch.arange(horizon, dtype=torch.float32, device=self.device)

    def make_aux(d0, params):
      times = d0.time + h * steps.to(d0.time.device)
      pos, vel = reference(clip.to(d0.time.device), times)  # (H, 6, 3)
      return torch.cat([pos.reshape(horizon, 18),
                        vel.reshape(horizon, 18)], dim=1).reshape(-1)

    return dict(dim=(nv - 6) + nu + ROWS_PER_STEP,
                naux=horizon * ROWS_PER_STEP, naux_static=0, fn=fn,
                make_aux=make_aux, header="residual_tracking.cuh",
                consts=self._geometry_consts(g))

