// Swimmer task residual as a device function of the step context: NU + 2
// rows — Control (the applied, clipped controls), then the nose-to-target
// error in x and y. Hand-written counterpart of tasks/swimmer.py:
// Swimmer.lane_residual_spec `fn`. aux rows: [target_x, target_y].
#pragma once

struct TaskConst {
  int nose_body[1];
};

__device__ __forceinline__ void task_residual(const StepCtx& c,
                                              const TaskConst& tc,
                                              float* res) {
  const int nose = tc.nose_body[0];
  for (int u = 0; u < NU; ++u) res[u] = c.ctrl[u];
  res[NU] = c.xpos[nose][0] - c.aux[0];
  res[NU + 1] = c.xpos[nose][1] - c.aux[1];
}
