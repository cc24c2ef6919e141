// Batched solve of symmetric positive definite systems A x = b, a team of
// lanes per system, the batch on the LAST axis of every array.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/cholesky.py:
// chol_solve_lanes. Per system: a Cholesky factorisation with the diagonal
// clamped at 1e-10 before the square root, then the forward and the
// backward triangular solve; each pivot's reciprocal is multiplied with,
// where the Pallas kernel divides (the plain PyTorch version,
// ops/cholesky.py chol_solve_lanes_plain, does the same).
//
// Layout: A (N, N, K) and b, x (N, K), row-major, K the batch. Element
// (i, j) of every system is one contiguous row of K floats. Only the lower
// triangle of A is read.
//
// Bound on an H100: bytes, on paper (a system moves N(N+1)/2 + 2N floats for
// about N^3/3 + 2N^2 operations, 1.5-3 operations a byte at N = 8-18, under
// the card's 20), but in practice the dependent chain of one system: N
// square roots and reciprocals and ~N^2/2 dependent updates. The design:
//  * a TEAM of lanes per system (CS_TEAM, a power of two <= 32, so a team
//    lies in one warp), row i of the system on lane i % TEAM (rows i, i +
//    TEAM, .. when N > TEAM), held in registers, the factor's row left of
//    the diagonal and its column below it in the same N floats: the factor
//    and both substitutions are the form of
//    lane_team.cuh team_chol_solve_rows, the pivot column and each
//    substitution step moving between lanes by __shfl_sync, with no barrier
//    and no shared memory; the same 1e-10 clamp and reciprocals, and every
//    entry of the factor and every forward step sees the same subtractions
//    in the same order as lane_math.cuh chol_solve (the back substitution
//    subtracts in the other order, k descending);
//  * staging through shared memory: a block stages the lower triangles and
//    right-hand sides of CS_SYS systems, neighbouring threads loading
//    neighbouring systems (a row of CS_SYS floats is one contiguous run of
//    global memory, 128 B at CS_SYS = 32), then each team reads its system
//    from shared memory (rows padded to an odd stride, so a team's lanes
//    read distinct banks), and x goes back out the same way.
// A block's teams take its systems in turn, every team the same number of
// rounds (systems past K are solved on zeros and not stored), so a block
// may have fewer threads than CS_TEAM * CS_SYS: the host build of the
// source runs one thread (tests/cuda_host_shim).
//
// Specialised at compile time: CS_N (system size), CS_TEAM (lanes a
// system), CS_SYS (systems a block), CS_THREADS (threads a block, default
// CS_TEAM * CS_SYS).

#include <cuda_runtime.h>
#include <math.h>

#if !defined(CS_N) || !defined(CS_TEAM) || !defined(CS_SYS)
#error "chol_solve_lanes.cu needs its compile-time sizes (see ops/cholesky.py)"
#endif
#if CS_TEAM < 1 || CS_TEAM > 32 || (CS_TEAM & (CS_TEAM - 1)) != 0
#error "CS_TEAM must be a power of two between 1 and 32"
#endif
#ifndef CS_THREADS
#define CS_THREADS (CS_TEAM * CS_SYS)
#endif
#if CS_THREADS % CS_TEAM != 0 || CS_SYS % (CS_THREADS / CS_TEAM) != 0
#error "a block holds whole teams, and its systems split evenly among them"
#endif

#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {
constexpr int N = CS_N;
constexpr int TEAM = CS_TEAM;
constexpr int SYS = CS_SYS;
constexpr int ROWS = (N + TEAM - 1) / TEAM;    // rows a lane
constexpr int TRI = N * (N + 1) / 2;           // entries of a lower triangle
constexpr int STRIDE = SYS | 1;                // floats a staged row
constexpr int STAGED = TRI + N;                // staged rows: A's triangle, b
constexpr int LOADS = (STAGED * SYS + CS_THREADS - 1) / CS_THREADS;
}  // namespace

// Row and column of entry r of a lower triangle stored row by row.
__device__ __forceinline__ void tri_entry(int r, int* i, int* j) {
  int row = (int)((sqrtf(8.0f * (float)r + 1.0f) - 1.0f) * 0.5f);
  while (row * (row + 1) / 2 > r) --row;
  while ((row + 1) * (row + 2) / 2 <= r) ++row;
  *i = row;
  *j = r - row * (row + 1) / 2;
}

extern "C" __global__ void __launch_bounds__(CS_THREADS)
chol_solve_lanes_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ x,
                        int k) {
  DYNAMIC_SMEM(smem_raw);
  float* staged = (float*)smem_raw;            // (STAGED, STRIDE)
  const int tid = threadIdx.x;
  const int first = blockIdx.x * SYS;

  // stage A's lower triangles and b: neighbouring threads, neighbouring
  // systems; systems past K as zeros. Every load of the thread is issued
  // before the first store, so they are in flight together.
  float v[LOADS];
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int e = tid + q * CS_THREADS;
    const int r = e / SYS, c = first + e % SYS;
    v[q] = 0.0f;
    if (e < STAGED * SYS && c < k) {
      if (r < TRI) {
        int i, j;
        tri_entry(r, &i, &j);
        v[q] = __ldg(a + (size_t)(i * N + j) * k + c);
      } else {
        v[q] = __ldg(b + (size_t)(r - TRI) * k + c);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int e = tid + q * CS_THREADS;
    if (e < STAGED * SYS) staged[(e / SYS) * STRIDE + e % SYS] = v[q];
  }
  __syncthreads();

  const int lane = tid % TEAM;
  const unsigned mask =
      (TEAM == 32 ? 0xffffffffu : ((1u << TEAM) - 1u)) << ((tid % 32) - lane);
  for (int s = tid / TEAM; s < SYS; s += CS_THREADS / TEAM) {
    // rows lane, lane + TEAM, ..: of row i, lc[q][j] holds the lower
    // triangle's entry (i, j) for j <= i, factored in place into L[i][j],
    // and, for j > i, L[j][i] (column i of L, kept as the factor goes)
    float lc[ROWS][N], rhs[ROWS], dinv[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int i = lane + q * TEAM;
#pragma unroll
      for (int j = 0; j < N; ++j)
        lc[q][j] = (i < N && j <= i)
                       ? staged[(i * (i + 1) / 2 + j) * STRIDE + s] : 0.0f;
      rhs[q] = i < N ? staged[(TRI + i) * STRIDE + s] : 0.0f;
      dinv[q] = 0.0f;
    }
    // factor, column by column: the pivot from the lane holding row j,
    // column j of L scaled on the lanes holding rows below it, then each
    // L[kk][j] shuffled out to update column kk of the rows at or below kk
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float ajj =
          __shfl_sync(mask, lc[j / TEAM][j], j % TEAM, TEAM);
      const float d = sqrtf(fmaxf(ajj, 1e-10f));
      const float dj = 1.0f / d;
      float l[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = lane + q * TEAM;
        l[q] = 0.0f;
        if (i == j) {
          dinv[q] = dj;
        } else if (i > j && i < N) {
          l[q] = lc[q][j] * dj;
          lc[q][j] = l[q];
        }
      }
#pragma unroll
      for (int kk = j + 1; kk < N; ++kk) {
        const float lkj = __shfl_sync(mask, l[kk / TEAM], kk % TEAM, TEAM);
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          const int i = lane + q * TEAM;
          if (i == j) lc[q][kk] = lkj;
          else if (i >= kk && i < N) lc[q][kk] -= l[q] * lkj;
        }
      }
    }
    // forward: y_j from the lane holding row j, then b_i -= L_ij y_j below
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float y = __shfl_sync(mask, rhs[j / TEAM] * dinv[j / TEAM],
                                  j % TEAM, TEAM);
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = lane + q * TEAM;
        if (i == j) rhs[q] = y;
        else if (i > j && i < N) rhs[q] -= lc[q][j] * y;
      }
    }
    // backward: x_kk from the lane holding row kk, then y_i -= L_kk,i x_kk
    // above it
#pragma unroll
    for (int kk = N - 1; kk >= 0; --kk) {
      const float xk = __shfl_sync(mask, rhs[kk / TEAM] * dinv[kk / TEAM],
                                   kk % TEAM, TEAM);
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = lane + q * TEAM;
        if (i == kk) rhs[q] = xk;
        else if (i < kk) rhs[q] -= lc[q][kk] * xk;
      }
    }
    // x into the staged b's place (this system's column, this team's own)
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int i = lane + q * TEAM;
      if (i < N) staged[(TRI + i) * STRIDE + s] = rhs[q];
    }
  }
  __syncthreads();
  for (int e = tid; e < N * SYS; e += CS_THREADS) {
    const int r = e / SYS, s = e % SYS, c = first + s;
    if (c < k) x[(size_t)r * k + c] = staged[(TRI + r) * STRIDE + s];
  }
}

extern "C" int chol_solve_lanes_n() { return CS_N; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int chol_solve_lanes(const float* a, const float* b, float* x,
                                int k, void* stream) {
  if (k <= 0) return 0;
  const int smem = STAGED * STRIDE * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_solve_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  opted_in = true;
  const int grid = (k + SYS - 1) / SYS;
  const int threads = CS_THREADS;
  chol_solve_lanes_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      a, b, x, k);
  return (int)cudaGetLastError();
}
