// What the humanoid residual headers share: the constant block, world
// position and velocity of a body-local point, and the com velocity of the
// torso subtree. Counterparts of tasks/humanoid.py site_point,
// subtree_comvel and the point velocities of tasks/tracking.py.
#pragma once

// World position (and velocity: lin + ang x (p - ref)) of a body-local point.
__device__ __forceinline__ void body_point(const StepCtx& c, int b,
                                           const float* local, float* p,
                                           float* v) {
  quat_rot(c.xquat[b], local, p);
  for (int k = 0; k < 3; ++k) p[k] = c.xpos[b][k] + p[k];
  if (v != nullptr) {
    const float* rf = c.subtree_com[tb.body_rootid[b]];
    const float d[3] = {p[0] - rf[0], p[1] - rf[1], p[2] - rf[2]};
    float wxd[3];
    cross3(c.cvel[b], d, wxd);
    for (int k = 0; k < 3; ++k) v[k] = c.cvel[b][3 + k] + wxd[k];
  }
}

// Linear velocity of the com of bodies ids[0 .. n), total mass `mass`.
__device__ __forceinline__ void subtree_comvel(const StepCtx& c,
                                               const int* ids, int n,
                                               float mass, float* out) {
  out[0] = out[1] = out[2] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int b = ids[i];
    const float* rf = c.subtree_com[tb.body_rootid[b]];
    const float d[3] = {c.xipos[b][0] - rf[0], c.xipos[b][1] - rf[1],
                        c.xipos[b][2] - rf[2]};
    float wxd[3];
    cross3(c.cvel[b], d, wxd);
    for (int k = 0; k < 3; ++k)
      out[k] += tb.body_mass[b] * (c.cvel[b][3 + k] + wxd[k]);
  }
  for (int k = 0; k < 3; ++k) out[k] = out[k] / mass;
}

// The humanoid's constant block (both residual headers).
struct TaskConst {
  int torso[1];
  int head_body[1];
  int feet_body[4];
  int nids[1];
  int ids[NBODY];        // bodies of the torso subtree (first nids valid)
  float head_pos[3];
  float feet_pos[4][3];
  float total_mass[1];
};
