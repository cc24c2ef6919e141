// Quadrotor task residual as a device function of the step context: 9 + NU
// rows — position error to the mocap goal, world-frame linear velocity of
// the body's com, angular velocity, control minus the hover thrust.
// Hand-written counterpart of tasks/quadrotor.py:Quadrotor.lane_residual_spec
// `fn`. aux rows: [goal_x, goal_y, goal_z].
#pragma once

struct TaskConst {
  int quad_body[1];
  float hover[1];
};

__device__ __forceinline__ void task_residual(const StepCtx& c,
                                              const TaskConst& tc,
                                              float* res) {
  const int b = tc.quad_body[0];
  for (int k = 0; k < 3; ++k) res[k] = c.xpos[b][k] - c.aux[k];
  const float* rf = c.subtree_com[tb.body_rootid[b]];
  const float d[3] = {c.xipos[b][0] - rf[0], c.xipos[b][1] - rf[1],
                      c.xipos[b][2] - rf[2]};
  float wxd[3];
  cross3(c.cvel[b], d, wxd);
  for (int k = 0; k < 3; ++k) res[3 + k] = c.cvel[b][3 + k] + wxd[k];
  for (int k = 0; k < 3; ++k) res[6 + k] = c.cvel[b][k];
  for (int u = 0; u < NU; ++u) res[9 + u] = c.ctrl[u] - tc.hover[0];
}
