// What the cube-in-hand residual headers (Rubik, Cube Solving, Hand
// Reorient) share: their constant block and the first 9 rows — cube
// position to the palm site, cube orientation to the goal quaternion (aux
// rows 0..3), cube linear velocity. Counterparts of the first rows of
// tasks/rubik.py and tasks/hand.py `fn` and of tasks/rubik.py
// orientation_rows.
#pragma once

struct TaskConst {
  int cube_body[1];
  int cube_dadr[1];
  int face_qadr[1];      // Rubik: the first face hinge's qpos address
  int nhand[1];          // hand joints: qpos / qvel 0 .. nhand
  float palm_pos[3];     // the palm site, on the world body
  float home[NQ];        // home posture of the hand (first nhand valid)
};

// The tangent difference quat_sub(goal, cube) = log(cube^-1 goal), shortest
// arc: three rows.
__device__ __forceinline__ void orientation_rows(const float* cq,
                                                 const float* gq,
                                                 float* out) {
  const float cc[4] = {cq[0], -cq[1], -cq[2], -cq[3]};
  float qd[4];
  quat_mul(cc, gq, qd);
  const float sgn = qd[0] < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 4; ++k) qd[k] = sgn * qd[k];
  const float sin_half =
      sqrtf(qd[1] * qd[1] + qd[2] * qd[2] + qd[3] * qd[3] + 1e-18f);
  const float angle = 2.0f * atan2f(sin_half, fmaxf(qd[0], 0.0f));
  const float scale = angle / fmaxf(sin_half, 1e-12f);
  for (int k = 0; k < 3; ++k) out[k] = qd[1 + k] * scale;
}

// rows 0..8: position, orientation, linear velocity of the cube
__device__ __forceinline__ void cube_rows(const StepCtx& c,
                                          const TaskConst& tc, float* res) {
  const int b = tc.cube_body[0];
  for (int k = 0; k < 3; ++k) res[k] = c.xpos[b][k] - tc.palm_pos[k];
  orientation_rows(c.xquat[b], c.aux, res + 3);
  for (int k = 0; k < 3; ++k) res[6 + k] = c.qvel[tc.cube_dadr[0] + k];
}
