// Walker task residual as a device function of the step context: NU + 3
// rows — Control (the applied, clipped controls), the torso height minus
// the goal, the torso z-axis's z component minus 1, and the forward (x)
// velocity of the centre of mass of every body but the world, minus the
// goal. Hand-written counterpart of tasks/walker.py:
// Walker.lane_residual_spec `fn`. aux rows: [height_goal, speed_goal].
#pragma once

struct TaskConst {
  int torso[1];
  int nids[1];
  int ids[NBODY];        // the bodies of the com (first nids valid)
  float total_mass[1];
};

__device__ __forceinline__ void task_residual(const StepCtx& c,
                                              const TaskConst& tc,
                                              float* res) {
  const int torso = tc.torso[0];
  for (int u = 0; u < NU; ++u) res[u] = c.ctrl[u];
  res[NU] = c.xpos[torso][2] - c.aux[0];
  const float ez[3] = {0.0f, 0.0f, 1.0f};
  float up[3];
  quat_rot(c.xquat[torso], ez, up);
  res[NU + 1] = up[2] - 1.0f;
  float vx = 0.0f;
  for (int i = 0; i < tc.nids[0]; ++i) {
    const int b = tc.ids[i];
    const float* rf = c.subtree_com[tb.body_rootid[b]];
    const float d[3] = {c.xipos[b][0] - rf[0], c.xipos[b][1] - rf[1],
                        c.xipos[b][2] - rf[2]};
    float wxd[3];
    cross3(c.cvel[b], d, wxd);
    vx += tb.body_mass[b] * (c.cvel[b][3] + wxd[0]);
  }
  res[NU + 2] = vx / tc.total_mass[0] - c.aux[1];
}
