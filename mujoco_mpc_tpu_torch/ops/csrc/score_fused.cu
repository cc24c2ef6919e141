// Fused trajectory scoring: residual rows -> per-term norms -> weighted sum
// -> mean over the horizon, one thread per candidate.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/scoring.py:
// score_fused (_score_kernel). For candidate c:
//   return[c] = (1/T) sum_t sum_terms w[i] * norm_i(res[t, off_i:off_i+dim_i, c])
// with the quadratic norm 0.5 |x|^2, the L2 norm sqrt(|x|^2 + p^2) - p and
// the smooth-abs norm sum_j sqrt(x_j^2 + p^2) - p (p the term's first norm
// parameter), summed in the Pallas kernel's order. Other norms and a
// risk-sensitive cost are refused by the wrapper's gate (ops/scoring.py).
//
// Layout: residuals (T, NR, K) row-major, K the candidates: the layout in
// which the rollout kernel and the batched pipeline rollouts record them, so
// no transpose is needed and neighbouring threads read neighbouring
// addresses. The weights and norm parameters are run-time arguments (a
// weight change rebuilds nothing); T and K are run-time too.
//
// Bound on an H100: bytes. Every residual is read once and costs a few
// operations (a square, an add, at most a square root): about 1 operation
// a byte against the card's 20 float32 operations a byte. One thread per
// candidate with the term structure compiled in is the simple version; it
// reads coalesced rows and keeps the sum in a register.
//
// Specialised at compile time: SF_NTERM (at most 16), SF_NR and, for
// each term i, SF_TYPE_i (norm type: 0 quadratic, 2 L2, 6 smooth-abs),
// SF_OFF_i (its first residual row) and SF_DIM_i (its rows); each term
// becomes one call of the template term_value with its structure as
// template arguments. (One define per number: nvcc splits a -D value at
// commas.)

#include <cuda_runtime.h>
#include <math.h>

#if !defined(SF_NTERM) || !defined(SF_NR) || SF_NTERM > 16
#error "score_fused.cu needs its compile-time term structure (see ops/scoring.py)"
#endif
#define BLOCK 128

#define NORM_QUADRATIC 0
#define NORM_L2 2
#define NORM_SMOOTH_ABS 6

// Unweighted norm of rows OFF .. OFF+DIM-1 of one step; r points at the
// step's first row of this candidate, rows are k floats apart.
template <int TYPE, int OFF, int DIM>
__device__ __forceinline__ float term_value(const float* __restrict__ r,
                                            int k, float p) {
  float y = 0.0f;
  if (TYPE == NORM_SMOOTH_ABS) {
    const float pp = p * p;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float x = __ldg(r + (size_t)(OFF + j) * k);
      y += sqrtf(x * x + pp) - p;
    }
  } else {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float x = __ldg(r + (size_t)(OFF + j) * k);
      s += x * x;
    }
    y = TYPE == NORM_QUADRATIC ? 0.5f * s : sqrtf(s + p * p) - p;
  }
  return y;
}

extern "C" __global__ void __launch_bounds__(BLOCK)
score_fused_kernel(const float* __restrict__ res,
                   const float* __restrict__ weights,
                   const float* __restrict__ p0, float* __restrict__ out,
                   int t_hor, int k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  float w[SF_NTERM], p[SF_NTERM];
#pragma unroll
  for (int i = 0; i < SF_NTERM; ++i) {
    w[i] = __ldg(weights + i);
    p[i] = __ldg(p0 + i);
  }
  float total = 0.0f;
  for (int t = 0; t < t_hor; ++t) {
    const float* r = res + (size_t)t * SF_NR * k + c;
    float step = 0.0f;
#define TERM(i) \
    step += w[i] * term_value<SF_TYPE_##i, SF_OFF_##i, SF_DIM_##i>(r, k, p[i]);
    TERM(0)
#if SF_NTERM > 1
    TERM(1)
#endif
#if SF_NTERM > 2
    TERM(2)
#endif
#if SF_NTERM > 3
    TERM(3)
#endif
#if SF_NTERM > 4
    TERM(4)
#endif
#if SF_NTERM > 5
    TERM(5)
#endif
#if SF_NTERM > 6
    TERM(6)
#endif
#if SF_NTERM > 7
    TERM(7)
#endif
#if SF_NTERM > 8
    TERM(8)
#endif
#if SF_NTERM > 9
    TERM(9)
#endif
#if SF_NTERM > 10
    TERM(10)
#endif
#if SF_NTERM > 11
    TERM(11)
#endif
#if SF_NTERM > 12
    TERM(12)
#endif
#if SF_NTERM > 13
    TERM(13)
#endif
#if SF_NTERM > 14
    TERM(14)
#endif
#if SF_NTERM > 15
    TERM(15)
#endif
#undef TERM
    total += step;
  }
  out[c] = total / (float)t_hor;
}

extern "C" int score_fused_nterm() { return SF_NTERM; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int score_fused(const float* res, const float* weights,
                           const float* p0, float* out, int t_hor, int k,
                           void* stream) {
  if (k <= 0) return 0;
  const int grid = (k + BLOCK - 1) / BLOCK;
  score_fused_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      res, weights, p0, out, t_hor, k);
  return (int)cudaGetLastError();
}
