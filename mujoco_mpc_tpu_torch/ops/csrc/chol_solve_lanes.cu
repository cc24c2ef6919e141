// Batched solve of symmetric positive definite systems A x = b, one system
// per thread, the batch on the LAST axis of every array.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/cholesky.py:
// chol_solve_lanes. Per system: an unrolled Cholesky factorisation with the
// diagonal clamped at 1e-10 before the square root, then the forward and the
// backward triangular solve. The arithmetic is the device function the
// rollout kernel already uses (lane_math.cuh chol_solve<N>), which multiplies
// by the reciprocal of each pivot where the Pallas kernel divides by it; the
// plain PyTorch version (ops/cholesky.py chol_solve_lanes_plain) does the
// same.
//
// Layout: A (N, N, K) and b, x (N, K), row-major, K the batch. Element
// (i, j) of every system is one contiguous row of K floats, so neighbouring
// threads read neighbouring addresses. Only the lower triangle of A is read.
//
// Bound on an H100: bytes, on paper. A system moves (N(N+1)/2 + 2N) floats
// (the lower triangle, b and x) for about N^3/3 + 2N^2 operations: about
// 1.5 operations a byte at N = 8 and 3 at N = 18, under the card's 20
// float32 operations a byte of memory bandwidth. In practice a launch is
// the dependent chain of one system (N square roots and reciprocals, ~N^2/2
// dependent updates) on 32 systems a warp instruction. A team of lanes a
// system (one row a lane, the pivot column by shuffles, the systems staged
// through shared memory) shortened that chain but ran 2-2.3x slower on an
// H100 at every shape measured, n = 4-18, K = 16-4,096 (PERF.md): it issues
// more warp instructions than it saves in chain length. So one thread keeps
// a whole system, with the factor in registers (no spill at N = 18: ptxas
// reports it in chip_smoke.py's build phase), and the reads stay coalesced
// by the batch-last layout.
//
// Specialised at compile time: CS_N (system size), CS_BLOCK (threads a
// block).

#include <cuda_runtime.h>
#include <math.h>

#if !defined(CS_N) || !defined(CS_BLOCK)
#error "chol_solve_lanes.cu needs its compile-time sizes (see ops/cholesky.py)"
#endif
#define BLOCK CS_BLOCK

#include "lane_math.cuh"

extern "C" __global__ void __launch_bounds__(BLOCK)
chol_solve_lanes_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ x,
                        int k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  float A[CS_N][CS_N];
  float rhs[CS_N], sol[CS_N];
#pragma unroll
  for (int i = 0; i < CS_N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j)
      A[i][j] = __ldg(a + (size_t)(i * CS_N + j) * k + c);
    rhs[i] = __ldg(b + (size_t)i * k + c);
  }
  chol_solve<CS_N>(A, rhs, sol);
#pragma unroll
  for (int i = 0; i < CS_N; ++i) x[(size_t)i * k + c] = sol[i];
}

extern "C" int chol_solve_lanes_n() { return CS_N; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int chol_solve_lanes(const float* a, const float* b, float* x,
                                int k, void* stream) {
  if (k <= 0) return 0;
  const int grid = (k + BLOCK - 1) / BLOCK;
  chol_solve_lanes_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a, b, x,
                                                                     k);
  return (int)cudaGetLastError();
}
