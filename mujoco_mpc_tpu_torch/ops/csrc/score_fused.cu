// Fused trajectory scoring: residual rows -> per-term norms -> weighted sum
// -> mean over the horizon, a tile of candidates by several slices of the
// horizon a block.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/scoring.py:
// score_fused (_score_kernel). For candidate c:
//   return[c] = (1/T) sum_t sum_terms w[i] * norm_i(res[t, off_i:off_i+dim_i, c])
// with the quadratic norm 0.5 |x|^2, the L2 norm sqrt(|x|^2 + p^2) - p and
// the smooth-abs norm sum_j sqrt(x_j^2 + p^2) - p (p the term's first norm
// parameter), the terms of a step summed in the Pallas kernel's order.
// Other norms and a risk-sensitive cost are refused by the wrapper's gate
// (ops/scoring.py).
//
// Layout: residuals (T, NR, K) given by run-time strides in floats (step,
// row, candidate), so both callers' tensors go in as they are: the rollout
// kernel's and the lane planner's (T, NR, K) rows (candidate stride 1) and
// the batched pipeline rollouts' (K, T, NR) batch seen through a permuted
// view (row stride 1). The weights (NTERM,) and the norm parameters
// (NTERM, nparam) come with their strides as well (only column 0 of the
// parameters is read); T and K are run-time too, so a weight change
// rebuilds nothing and no call copies its inputs.
//
// Bound on an H100: bytes. Every residual is read once and costs a few
// operations (a square, an add, at most a square root): about 1 operation
// a byte against the card's 20 float32 operations a byte. The first
// version ran one thread a candidate over the whole horizon: a chain of T
// steps of loads a thread, and at K = 10-16 one block with 10-16 working
// threads (~0.2 us a step), at K = 4096 32 blocks on 132 SMs with too few
// loads in flight to cover the memory latency. Here:
//  * a block is a TILE of neighbouring candidates (threads t % TILE, so a
//    row of a step is one coalesced read where the candidate stride is 1)
//    by SLICES slices of the horizon (threads t / TILE): slice s sums the
//    steps s, s + SLICES, .. of its candidate in ascending order, so each
//    thread's chain is T / SLICES steps and a launch has K * SLICES
//    threads, each step's loads independent of the sum;
//  * the slices' partial sums are added by a fixed tree, no atomics: first
//    the slices of a warp (lanes TILE apart) by xor shuffles, then the
//    warps' sums in shared memory (warp w += warp w + h for h = warps / 2,
//    .., 1, a block barrier a level); a launch's result depends only on
//    its layout, the same on every run;
//  * the horizon is not split across blocks: the launch rule spreads the
//    candidates over the SMs (a tile of about K / SMs candidates a block)
//    and gives each thread one or two steps, which fills the card at
//    K = 4096 and leaves the small batches a few microseconds of work, so
//    no second pass or cluster reduction is needed.
// TILE (a power of two <= 32) and SLICES (a power of two, TILE * SLICES <=
// 1024) are launch arguments: ops/scoring.py `layout` is the launch rule.
// Shared memory: TILE floats a warp.
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
#define MAX_THREADS 1024
#ifndef SF_WARP
#define SF_WARP 32   // lanes a warp (a threaded host build emulates fewer)
#endif

#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

#define NORM_QUADRATIC 0
#define NORM_L2 2
#define NORM_SMOOTH_ABS 6

// Unweighted norm of rows OFF .. OFF+DIM-1 of one step; r points at the
// step's first row of this candidate, rows are sr floats apart.
template <int TYPE, int OFF, int DIM>
__device__ __forceinline__ float term_value(const float* __restrict__ r,
                                            long long sr, float p) {
  float y = 0.0f;
  if (TYPE == NORM_SMOOTH_ABS) {
    const float pp = p * p;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float x = __ldg(r + (OFF + j) * sr);
      y += sqrtf(x * x + pp) - p;
    }
  } else {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const float x = __ldg(r + (OFF + j) * sr);
      s += x * x;
    }
    y = TYPE == NORM_QUADRATIC ? 0.5f * s : sqrtf(s + p * p) - p;
  }
  return y;
}

extern "C" __global__ void __launch_bounds__(MAX_THREADS)
score_fused_kernel(const float* __restrict__ res, long long st, long long sr,
                   long long sc, const float* __restrict__ weights,
                   long long ws, const float* __restrict__ params,
                   long long ps, float* __restrict__ out, int t_hor, int k,
                   int tile_log2, int slices) {
  DYNAMIC_SMEM(smem_raw);
  float* part = (float*)smem_raw;              // (warps, TILE)
  const int tile = 1 << tile_log2;
  const int lane = threadIdx.x & (tile - 1);
  const int slice = threadIdx.x >> tile_log2;
  const int c = blockIdx.x * tile + lane;
  float total = 0.0f;
  if (c < k) {
    float w[SF_NTERM], p[SF_NTERM];
#pragma unroll
    for (int i = 0; i < SF_NTERM; ++i) {
      w[i] = __ldg(weights + i * ws);
      p[i] = __ldg(params + i * ps);
    }
    const float* base = res + (long long)c * sc;
#pragma unroll 2
    for (int t = slice; t < t_hor; t += slices) {
      const float* r = base + (long long)t * st;
      float step = 0.0f;
#define TERM(i) \
  step += w[i] * term_value<SF_TYPE_##i, SF_OFF_##i, SF_DIM_##i>(r, sr, p[i]);
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
  }
  // the slices' sums by a fixed tree; every thread of the block reaches
  // every shuffle and barrier (a lane past K adds zeros). First the slices
  // a warp holds (lanes tile apart), by xor shuffles: every lane of a
  // candidate ends with the same sum.
  const int threads = slices << tile_log2;
  const int width = threads < SF_WARP ? threads : SF_WARP;
  const unsigned mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
  for (int m = tile; m < width; m <<= 1)
    total += __shfl_xor_sync(mask, total, m);
  // then the warps' sums through shared memory, warp w += warp w + h
  const int warps = threads / width;
  const int warp = threadIdx.x / width;
  const bool first = threadIdx.x % width < tile;   // one lane a candidate
  if (warps > 1) {
    if (first) part[warp * tile + lane] = total;
    __syncthreads();
    for (int h = warps >> 1; h > 0; h >>= 1) {
      if (first && warp < h)
        part[warp * tile + lane] += part[(warp + h) * tile + lane];
      __syncthreads();
    }
    total = part[lane];
  }
  if (warp == 0 && first && c < k) out[c] = total / (float)t_hor;
}

extern "C" int score_fused_nterm() { return SF_NTERM; }

// Launch on `stream` at a tile of 2^tile_log2 candidates by `slices` slices
// of the horizon a block; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a layout the kernel does not take.
extern "C" int score_fused(const float* res, long long st, long long sr,
                           long long sc, const float* weights, long long ws,
                           const float* params, long long ps, float* out,
                           int t_hor, int k, int tile_log2, int slices,
                           void* stream) {
  if (k <= 0) return 0;
  if (tile_log2 < 0 || tile_log2 > 5 || slices < 1 ||
      (slices & (slices - 1)) != 0 || (slices << tile_log2) > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int tile = 1 << tile_log2;
  const int grid = (k + tile - 1) / tile;
  const int threads = tile * slices;
  const int warps = threads < SF_WARP ? 1 : threads / SF_WARP;
  const int smem = warps * tile * (int)sizeof(float);
  score_fused_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      res, st, sr, sc, weights, ws, params, ps, out, t_hor, k, tile_log2,
      slices);
  return (int)cudaGetLastError();
}
