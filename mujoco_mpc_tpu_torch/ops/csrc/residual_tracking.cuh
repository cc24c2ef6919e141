// Humanoid Track task residual as a device function of the step context:
// (NV - 6) + NU + 36 rows — joint velocity, control, then the position and
// the velocity tracking errors of six points (head, torso-subtree com, four
// foot sites). Hand-written counterpart of tasks/tracking.py:
// HumanoidTracking.lane_residual_spec `fn`. Every aux row is per step: the
// clip targets of step t are rows t*36 + i (positions 0..17, velocities
// 18..35), read from global memory through c.aux_at.
#pragma once

#include "humanoid_common.cuh"

__device__ void task_residual(const StepCtx& c, const TaskConst& tc,
                              float* res) {
  float p[6][3], v[6][3];
  body_point(c, tc.head_body[0], tc.head_pos, p[0], v[0]);
  for (int k = 0; k < 3; ++k) p[1][k] = c.subtree_com[tc.torso[0]][k];
  subtree_comvel(c, tc.ids, tc.nids[0], tc.total_mass[0], v[1]);
  for (int i = 0; i < 4; ++i)
    body_point(c, tc.feet_body[i], tc.feet_pos[i], p[2 + i], v[2 + i]);
  int r = 0;
  for (int i = 6; i < NV; ++i) res[r++] = c.qvel[i];
  for (int u = 0; u < NU; ++u) res[r++] = c.ctrl[u];
  const int base = c.t * 36;
  for (int j = 0; j < 6; ++j)
    for (int k = 0; k < 3; ++k) res[r++] = p[j][k] - c.aux_at(base + 3 * j + k);
  for (int j = 0; j < 6; ++j)
    for (int k = 0; k < 3; ++k)
      res[r++] = v[j][k] - c.aux_at(base + 18 + 3 * j + k);
}
