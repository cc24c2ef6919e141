// Vector, quaternion and small dense linear algebra device functions for
// the lane rollout kernel. One thread works on one candidate, so these are
// plain scalar routines; the plain PyTorch counterparts are in
// ops/lanemath.py. No fast-math: divisions and square roots are IEEE.
#pragma once

#include <math.h>

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  const float x = a[1] * b[2] - a[2] * b[1];
  const float y = a[2] * b[0] - a[0] * b[2];
  const float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

// Hamilton product o = u * v (w, x, y, z); o may alias u or v.
__device__ __forceinline__ void quat_mul(const float* u, const float* v,
                                         float* o) {
  const float w1 = u[0], x1 = u[1], y1 = u[2], z1 = u[3];
  const float w2 = v[0], x2 = v[1], y2 = v[2], z2 = v[3];
  o[0] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  o[1] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[2] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[3] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
}

// Rotate v by q (local -> world): v + 2 w (u x v) + 2 u x (u x v).
// o may alias v.
__device__ __forceinline__ void quat_rot(const float* q, const float* v,
                                         float* o) {
  const float w = q[0];
  const float u[3] = {q[1], q[2], q[3]};
  const float vv[3] = {v[0], v[1], v[2]};
  float uv[3], uuv[3];
  cross3(u, vv, uv);
  cross3(u, uv, uuv);
  o[0] = vv[0] + (uv[0] * w + uuv[0]) * 2.0f;
  o[1] = vv[1] + (uv[1] * w + uuv[1]) * 2.0f;
  o[2] = vv[2] + (uv[2] * w + uuv[2]) * 2.0f;
}

// 3D tangent difference of two quaternions: the velocity v with
// qb * exp(v/2) = qa (mju_subQuat). Counterpart of lanemath.quat_sub_tangent.
__device__ __forceinline__ void quat_sub_tangent(const float* qa,
                                                 const float* qb, float* o) {
  const float aw = qa[0], ax = qa[1], ay = qa[2], az = qa[3];
  const float bw = qb[0], bx = qb[1], by = qb[2], bz = qb[3];
  float w = bw * aw + bx * ax + by * ay + bz * az;
  float x = bw * ax - bx * aw - by * az + bz * ay;
  float y = bw * ay + bx * az - by * aw - bz * ax;
  float z = bw * az - bx * ay + by * ax - bz * aw;
  const float inv =
      1.0f / sqrtf(fmaxf(w * w + x * x + y * y + z * z, 1e-24f));
  const float sign = w < 0.0f ? -inv : inv;   // shortest arc, unit norm
  w *= sign; x *= sign; y *= sign; z *= sign;
  const float sin_half = sqrtf(fmaxf(x * x + y * y + z * z, 0.0f));
  const float s = 2.0f * atan2f(sin_half, w) / fmaxf(sin_half, 1e-12f);
  o[0] = x * s; o[1] = y * s; o[2] = z * s;
}

// Spatial inertia (Ixx Ixy Ixz Iyy Iyz Izz hx hy hz mass, about the
// reference point) times motion (angular 0..2, linear 3..5) -> force
// (torque 0..2, force 3..5).
__device__ __forceinline__ void inertia_mul(const float* in, const float* mot,
                                            float* f) {
  const float* w = mot;
  const float* v = mot + 3;
  const float* hv = in + 6;
  const float mass = in[9];
  float hxv[3], hxw[3];
  cross3(hv, v, hxv);
  cross3(hv, w, hxw);
  f[0] = in[0] * w[0] + in[1] * w[1] + in[2] * w[2] + hxv[0];
  f[1] = in[1] * w[0] + in[3] * w[1] + in[4] * w[2] + hxv[1];
  f[2] = in[2] * w[0] + in[4] * w[1] + in[5] * w[2] + hxv[2];
  f[3] = v[0] * mass - hxw[0];
  f[4] = v[1] * mass - hxw[1];
  f[5] = v[2] * mass - hxw[2];
}

// Spatial motion cross product o = a x b (motion vectors).
__device__ __forceinline__ void motion_cross(const float* a, const float* b,
                                             float* o) {
  float t0[3], t1[3], t2[3];
  cross3(a, b, t0);
  cross3(a, b + 3, t1);
  cross3(a + 3, b, t2);
  o[0] = t0[0]; o[1] = t0[1]; o[2] = t0[2];
  o[3] = t1[0] + t2[0]; o[4] = t1[1] + t2[1]; o[5] = t1[2] + t2[2];
}

// Solve A x = b for symmetric positive definite A (lower triangle read),
// factoring in place: on return the lower triangle of A holds L. The
// diagonal is clamped at 1e-10 before the square root, as the plain
// version's chol_solve_packed does. x may alias b.
//
// N is a compile-time dimension and every loop unrolls completely: with one
// warp on an SM nothing else hides a load's latency, and straight-line code
// lets the compiler issue a column's loads ahead of the multiplies that use
// them. Each pivot is inverted once and multiplied with (one division a
// column instead of one an entry). Measured on the flagship launch: rolled
// loops 21.3 ms, unrolled 16.1 ms, with the reciprocal 11.1 ms.
// Past kCholUnrollMax rows the loops stay rolled: fully unrolled at n = 32
// (Cube Solving's nv) nvcc took 221 s for the rollout kernel and ptxas
// spilled 14 KB; rolled, 25 s and 1 KB. Every size up to 28 (the humanoid's
// 27 among them) keeps the unrolled form measured above.
constexpr int kCholUnrollMax = 28;

// chol_solve with rolled loops, the same arithmetic in the same order
template <int N>
__device__ void chol_solve_rolled(float (*A)[N], const float* b, float* x) {
  float dinv[N];
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    float s = A[j][j];
    for (int k = 0; k < j; ++k) s -= A[j][k] * A[j][k];
    const float d = sqrtf(fmaxf(s, 1e-10f));
    A[j][j] = d;
    dinv[j] = 1.0f / d;
#pragma unroll 1
    for (int i = j + 1; i < N; ++i) {
      float si = A[i][j];
      for (int k = 0; k < j; ++k) si -= A[i][k] * A[j][k];
      A[i][j] = si * dinv[j];
    }
  }
  float y[N];
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i][k] * y[k];
    y[i] = s * dinv[i];
  }
#pragma unroll 1
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < N; ++k) s -= A[k][i] * x[k];
    x[i] = s * dinv[i];
  }
}

template <int N>
__device__ void chol_solve(float (*A)[N], const float* b, float* x) {
  if constexpr (N > kCholUnrollMax) {
    chol_solve_rolled<N>(A, b, x);
    return;
  }
  float dinv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= A[j][k] * A[j][k];
    const float d = sqrtf(fmaxf(s, 1e-10f));
    A[j][j] = d;
    dinv[j] = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float si = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) si -= A[i][k] * A[j][k];
      A[i][j] = si * dinv[j];
    }
  }
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= A[i][k] * y[k];
    y[i] = s * dinv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= A[k][i] * x[k];
    x[i] = s * dinv[i];
  }
}

// Python-style modulo for a positive modulus: result in [0, m).
__device__ __forceinline__ float mod_floor(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && r < 0.0f) r += m;
  return r;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
