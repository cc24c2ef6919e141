// Humanoid Stand / Walk task residual as a device function of the step
// context: 4 + (NV - 6) + NU rows — Height (head over the average foot
// site, minus the goal), Balance (capture point vs average foot position),
// com velocity (x minus the speed goal, y), joint velocity, control.
// Hand-written counterpart of tasks/humanoid.py:HumanoidStand.
// lane_residual_spec `fn`. aux rows: [height_goal, speed_goal].
#pragma once

#include "humanoid_common.cuh"

__device__ void task_residual(const StepCtx& c, const TaskConst& tc,
                              float* res) {
  float fp[4][3], favg[3], head[3], comvel[3];
  for (int i = 0; i < 4; ++i)
    body_point(c, tc.feet_body[i], tc.feet_pos[i], fp[i], nullptr);
  for (int k = 0; k < 3; ++k)
    favg[k] = (fp[0][k] + fp[1][k] + fp[2][k] + fp[3][k]) / 4.0f;
  body_point(c, tc.head_body[0], tc.head_pos, head, nullptr);
  subtree_comvel(c, tc.ids, tc.nids[0], tc.total_mass[0], comvel);
  const float* com = c.subtree_com[tc.torso[0]];
  const float dx = com[0] + 0.2f * comvel[0] - favg[0] + 1e-8f;
  const float dy = com[1] + 0.2f * comvel[1] - favg[1] + 1e-8f;
  res[0] = head[2] - favg[2] - c.aux[0];
  res[1] = sqrtf(dx * dx + dy * dy);
  res[2] = comvel[0] - c.aux[1];
  res[3] = comvel[1];
  for (int i = 6; i < NV; ++i) res[4 + i - 6] = c.qvel[i];
  for (int u = 0; u < NU; ++u) res[4 + NV - 6 + u] = c.ctrl[u];
}
