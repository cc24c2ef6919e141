// Rubik / Cube Solving task residual as a device function of the step
// context: 9 + NU + 6 + 2 nhand + 1 rows — the cube rows of
// cube_common.cuh, actuator force, the six face angles against their goals
// times the mode gate, hand posture against home, hand joint velocity, the
// remaining-goal cost. Hand-written counterpart of tasks/rubik.py:
// Rubik.lane_residual_spec `fn`. aux rows: [goal quaternion (4), face goals
// (6), mode gate, remaining-goal cost].
#pragma once

#include "cube_common.cuh"

__device__ void task_residual(const StepCtx& c, const TaskConst& tc,
                              float* res) {
  cube_rows(c, tc, res);
  int r = 9;
  for (int u = 0; u < NU; ++u) res[r++] = c.act_force[u];
  const int qa_f = tc.face_qadr[0];
  for (int i = 0; i < 6; ++i)
    res[r++] = c.aux[10] * (c.qpos[qa_f + i] - c.aux[4 + i]);
  const int nhand = tc.nhand[0];
  for (int i = 0; i < nhand; ++i) res[r++] = c.qpos[i] - tc.home[i];
  for (int i = 0; i < nhand; ++i) res[r++] = c.qvel[i];
  res[r] = c.aux[11] + 0.0f * c.qpos[0];
}
