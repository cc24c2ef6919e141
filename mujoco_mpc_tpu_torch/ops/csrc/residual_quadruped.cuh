// Quadruped Flat task residual (Quadruped mode) as a device function of
// the step context: 42 rows — Upright 3, Height 1, Position 3, Gait 4,
// Balance 2, Effort 12, Posture 12, Orientation 2, Angmom 3. Hand-written
// counterpart of tasks/quadruped.py:QuadrupedFlat.lane_residual_spec `fn`.
// aux rows: [time0, goal_x, goal_y, phase0, phase_vel, amplitude, duty,
// cos(heading), sin(heading), footphase x4].
#pragma once

struct TaskConst {
  int trunk[1];
  int head_body[1];
  int feet_body[4];
  int nids[1];
  int ids[NBODY];        // bodies of the trunk subtree (first nids valid)
  float head_pos[3];
  float feet_pos[4][3];
  float home[12];
  float gains[12];
  float total_mass[1];
  float fall_time[1];
};

__device__ void task_residual(const StepCtx& c, const TaskConst& tc,
                              float* res) {
  const float kPi = 3.14159265358979323846f;
  const float kFootRadius = 0.02f;
  const float kHeight = 0.25f;
  const int trunk = tc.trunk[0];
  const float time = c.aux[0] + (float)((double)c.t * (double)tb.timestep[0]);

  float fp[4][3];
  float avg[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 4; ++i) {
    const int b = tc.feet_body[i];
    quat_rot(c.xquat[b], tc.feet_pos[i], fp[i]);
    for (int k = 0; k < 3; ++k) fp[i][k] += c.xpos[b][k];
  }
  for (int k = 0; k < 3; ++k)
    avg[k] = (fp[0][k] + fp[1][k] + fp[2][k] + fp[3][k]) * 0.25f;

  int r = 0;
  // Upright
  const float ez[3] = {0.0f, 0.0f, 1.0f};
  float z[3];
  quat_rot(c.xquat[trunk], ez, z);
  res[r++] = z[2] - 1.0f;
  res[r++] = 0.0f;
  res[r++] = 0.0f;
  // Height
  res[r++] = c.xipos[trunk][2] - avg[2] - kHeight;
  // Position
  float head[3];
  quat_rot(c.xquat[tc.head_body[0]], tc.head_pos, head);
  res[r++] = head[0] + c.xpos[tc.head_body[0]][0] - c.aux[1];
  res[r++] = head[1] + c.xpos[tc.head_body[0]][1] - c.aux[2];
  res[r++] = 0.0f;
  // Gait
  const float phase = c.aux[3] + time * c.aux[4];
  const float amplitude = c.aux[5], duty = c.aux[6];
  for (int i = 0; i < 4; ++i) {
    float ang = phase - c.aux[9 + i];
    ang = mod_floor(ang + kPi, 2.0f * kPi) - kPi;
    ang = ang * 0.5f / fmaxf(1.0f - duty, 1e-3f);
    float stp = fabsf(cosf(clampf(ang, -kPi / 2, kPi / 2)));
    stp = stp < 1e-6f ? 0.0f : stp;
    stp = amplitude * (duty < 1.0f ? stp : 0.0f);
    const float target = kFootRadius + stp;
    res[r++] = stp > 0.0f ? fp[i][2] - target : 0.0f;
  }
  // Balance: capture point vs average foot position. Body com linear
  // velocity: lin + ang x (xipos - ref).
  float comvel[3] = {0.0f, 0.0f, 0.0f};
  const int nids = tc.nids[0];
  for (int n = 0; n < nids; ++n) {
    const int b = tc.ids[n];
    const float* rf = c.subtree_com[tb.body_rootid[b]];
    const float d[3] = {c.xipos[b][0] - rf[0], c.xipos[b][1] - rf[1],
                        c.xipos[b][2] - rf[2]};
    float wxd[3];
    cross3(c.cvel[b], d, wxd);
    for (int k = 0; k < 3; ++k)
      comvel[k] += tb.body_mass[b] * (c.cvel[b][3 + k] + wxd[k]);
  }
  for (int k = 0; k < 3; ++k) comvel[k] /= tc.total_mass[0];
  res[r++] = c.subtree_com[trunk][0] + tc.fall_time[0] * comvel[0] - avg[0];
  res[r++] = c.subtree_com[trunk][1] + tc.fall_time[0] * comvel[1] - avg[1];
  // Effort
  for (int u = 0; u < NU; ++u) res[r++] = 2e-2f * c.act_force[u];
  // Posture
  for (int i = 0; i < 12; ++i)
    res[r++] = (c.qpos[7 + i] - tc.home[i]) * tc.gains[i];
  // Orientation (heading)
  const float ex[3] = {1.0f, 0.0f, 0.0f};
  float hd[3];
  quat_rot(c.xquat[trunk], ex, hd);
  const float nrm = fmaxf(sqrtf(hd[0] * hd[0] + hd[1] * hd[1]), 1e-8f);
  res[r++] = hd[0] / nrm - c.aux[7];
  res[r++] = hd[1] / nrm - c.aux[8];
  // Angular momentum of the trunk subtree about its com
  float am[3] = {0.0f, 0.0f, 0.0f};
  for (int n = 0; n < nids; ++n) {
    const int b = tc.ids[n];
    const float* rf = c.subtree_com[tb.body_rootid[b]];
    const float d[3] = {c.xipos[b][0] - rf[0], c.xipos[b][1] - rf[1],
                        c.xipos[b][2] - rf[2]};
    float wxd[3];
    cross3(c.cvel[b], d, wxd);
    float rr[3], dv[3], orb[3];
    for (int k = 0; k < 3; ++k) {
      rr[k] = c.xipos[b][k] - c.subtree_com[trunk][k];
      dv[k] = c.cvel[b][3 + k] + wxd[k] - comvel[k];
    }
    cross3(rr, dv, orb);
    for (int k = 0; k < 3; ++k) am[k] += tb.body_mass[b] * orb[k];
    float q[4];
    quat_mul(c.xquat[b], tb.body_iquat[b], q);
    for (int kk = 0; kk < 3; ++kk) {
      float e[3] = {0.0f, 0.0f, 0.0f};
      e[kk] = 1.0f;
      float ek[3];
      quat_rot(q, e, ek);
      const float proj = dot3(ek, c.cvel[b]);
      for (int k = 0; k < 3; ++k)
        am[k] += tb.body_inertia[b][kk] * proj * ek[k];
    }
  }
  res[r++] = am[0];
  res[r++] = am[1];
  res[r++] = am[2];
}
