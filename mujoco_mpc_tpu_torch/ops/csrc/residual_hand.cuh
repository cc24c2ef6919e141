// Hand Reorient task residual as a device function of the step context:
// 9 + NU + 2 nhand rows — the cube rows of cube_common.cuh, actuator
// force, hand posture against home, hand joint velocity. Hand-written
// counterpart of tasks/hand.py:HandReorient.lane_residual_spec `fn`. aux
// rows: the goal quaternion.
#pragma once

#include "cube_common.cuh"

__device__ void task_residual(const StepCtx& c, const TaskConst& tc,
                              float* res) {
  cube_rows(c, tc, res);
  int r = 9;
  for (int u = 0; u < NU; ++u) res[r++] = c.act_force[u];
  const int nhand = tc.nhand[0];
  for (int i = 0; i < nhand; ++i) res[r++] = c.qpos[i] - tc.home[i];
  for (int i = 0; i < nhand; ++i) res[r++] = c.qvel[i];
}
