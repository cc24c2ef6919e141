// A team of TEAM lanes working on one candidate of the lane rollout kernel,
// and the Hopper primitives the kernel's block uses to stage its tables.
//
// TEAM is a power of two <= 32, so a team lies inside one warp: its lanes
// meet at __syncwarp(mask) and exchange values by warp shuffles. Every
// function here is collective over the team (all its lanes call it, in
// step) unless it says otherwise. Work is split by strided loops
// (`for (i = lane; i < n; i += TEAM)`), so at TEAM = 1 every loop is the
// serial loop and every reduction the identity: the host build of the
// source (tests/cuda_host_shim) runs it that way, one thread at a time.
#pragma once

#include <stdint.h>

#ifndef TEAM
#error "lane_team.cuh needs TEAM"
#endif
#if TEAM < 1 || TEAM > 32 || (TEAM & (TEAM - 1)) != 0
#error "TEAM must be a power of two between 1 and 32"
#endif

// The block's dynamic shared memory (the host build's shim declares its own).
#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

struct Team {
  int lane;        // 0 .. TEAM - 1
  int shift;       // the team's first lane within its warp
  unsigned mask;   // the team's lanes within its warp
};

__device__ __forceinline__ Team make_team(int tid) {
  Team tm;
  tm.lane = tid % TEAM;
  tm.shift = (tid % 32) - tm.lane;
  tm.mask = (TEAM == 32 ? 0xffffffffu : ((1u << TEAM) - 1u)) << tm.shift;
  return tm;
}

__device__ __forceinline__ void team_sync(const Team& tm) {
  __syncwarp(tm.mask);
}

// Sum over the team by a fixed xor butterfly: every lane ends with the same
// value (each pair adds the same two operands), the same in every run.
__device__ __forceinline__ float team_sum(const Team& tm, float v) {
#pragma unroll
  for (int o = TEAM / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(tm.mask, v, o, TEAM);
  return v;
}

// The team's predicate bits, lane 0 in bit 0.
__device__ __forceinline__ unsigned team_ballot(const Team& tm, bool p) {
  const unsigned b = __ballot_sync(tm.mask, p) >> tm.shift;
  return TEAM == 32 ? b : b & ((1u << TEAM) - 1u);
}

// Appends the indices i in [0, n) with pred(i) to list, in increasing order
// (a ballot per TEAM indices and each lane's rank among them); returns the
// count, the same on every lane, with the list visible to every lane.
template <class Pred>
__device__ __forceinline__ int team_compact(const Team& tm, int n, Pred pred,
                                            int* list) {
  int count = 0;
  for (int base = 0; base < n; base += TEAM) {
    const int i = base + tm.lane;
    const bool p = i < n && pred(i);
    const unsigned bits = team_ballot(tm, p);
    if (p) list[count + __popc(bits & ((1u << tm.lane) - 1u))] = i;
    count += __popc(bits);
  }
  team_sync(tm);
  return count;
}

// Exclusive prefix sum of w over the team's lanes; *total gets the sum.
__device__ __forceinline__ int team_scan(const Team& tm, int w, int* total) {
  int x = w;
#pragma unroll
  for (int o = 1; o < TEAM; o <<= 1) {
    const int y = __shfl_up_sync(tm.mask, x, o, TEAM);
    if (tm.lane >= o) x += y;
  }
  *total = __shfl_sync(tm.mask, x, TEAM - 1, TEAM);
  return x - w;
}

// Calls f(r, c) for the entries of a lower triangle of m rows (row r holds
// columns 0 .. r), entry q = r (r + 1) / 2 + c taken by lane q % TEAM.
template <class F>
__device__ __forceinline__ void team_for_tri(const Team& tm, int m, F f) {
  int r = 0, c = tm.lane;
  while (r < m && c > r) { c -= r + 1; ++r; }
  while (r < m) {
    f(r, c);
    c += TEAM;
    while (r < m && c > r) { c -= r + 1; ++r; }
  }
}

// Solve A x = b for symmetric positive definite A (N x N, row stride LD,
// lower triangle read and overwritten by its factor L), x may alias b: the
// cooperative form of lane_math.cuh chol_solve, with the same 1e-10 clamp
// of the diagonal before its square root and each pivot's reciprocal
// multiplied with. Every entry of L sees the same subtractions in the same
// order as in chol_solve (k = 0, 1, ..), and so does the forward
// substitution (y_i = (b_i - sum_j L_ij y_j) / L_ii, j ascending); the back
// substitution subtracts in the other order (k descending). Two forms:
//  * N <= TEAM (one row a lane): lane i works on row i of A in shared
//    memory (rows of odd length sit in distinct banks); the pivot and
//    column j of the factor, and each step of the substitutions, reach the
//    other lanes by shuffles from lane j or lane k, with no barrier but one
//    before the back substitution, which reads the factor's columns;
//  * N > TEAM: right-looking in shared memory, column by column: the lanes
//    scale the column below the pivot, then update the trailing triangle,
//    entry (i, k) owned by one lane, with team barriers between.
// dinv holds N floats of scratch (the pivots' reciprocals).
template <int N, int LD>
__device__ void team_chol_solve_rows(const Team& tm, float (*A)[LD],
                                     const float* b, float* x, float* dinv) {
  const int i = tm.lane;
  const bool mine = i < N;
  float bi = mine ? b[i] : 0.0f;
  float di = 0.0f;
  for (int j = 0; j < N; ++j) {
    const float ajj = __shfl_sync(tm.mask, mine ? A[i][j] : 0.0f, j, TEAM);
    const float d = sqrtf(fmaxf(ajj, 1e-10f));
    const float dj = 1.0f / d;
    float lij = 0.0f;
    if (i == j) {
      A[j][j] = d;
      di = dj;
    } else if (mine && i > j) {
      lij = A[i][j] * dj;
      A[i][j] = lij;
    }
#pragma unroll 4
    for (int k = j + 1; k < N; ++k) {
      const float lkj = __shfl_sync(tm.mask, lij, k, TEAM);
      if (mine && i >= k) A[i][k] -= lij * lkj;
    }
  }
  // forward: y_j from lane j, then b_i -= L_ij y_j below it
  for (int j = 0; j < N; ++j) {
    const float y = __shfl_sync(tm.mask, bi * di, j, TEAM);
    if (i == j) bi = y;
    else if (mine && i > j) bi -= A[i][j] * y;
  }
  if (mine) dinv[i] = di;
  team_sync(tm);
  // backward: x_k from lane k, then y_i -= L_ki x_k above it
  for (int k = N - 1; k >= 0; --k) {
    const float xk = __shfl_sync(tm.mask, bi * di, k, TEAM);
    if (i == k) bi = xk;
    else if (i < k) bi -= A[k][i] * xk;
  }
  if (mine) x[i] = bi;
  team_sync(tm);
}

template <int N, int LD>
__device__ void team_chol_solve(const Team& tm, float (*A)[LD],
                                const float* b, float* x, float* dinv) {
  if constexpr (N <= TEAM) {
    team_sync(tm);
    team_chol_solve_rows<N, LD>(tm, A, b, x, dinv);
    return;
  }
  constexpr int n = N;
  for (int i = tm.lane; i < n; i += TEAM) x[i] = b[i];
  for (int j = 0; j < n; ++j) {
    team_sync(tm);
    const float d = sqrtf(fmaxf(A[j][j], 1e-10f));
    const float di = 1.0f / d;
    for (int i = j + 1 + tm.lane; i < n; i += TEAM) A[i][j] = A[i][j] * di;
    team_sync(tm);
    // nobody reads the pivot again until the next column
    if (tm.lane == 0) {
      A[j][j] = d;
      dinv[j] = di;
    }
    team_for_tri(tm, n - j - 1, [&](int r, int c) {
      const int i = j + 1 + r, k = j + 1 + c;
      A[i][k] -= A[i][j] * A[k][j];
    });
  }
  // forward: y_j = x_j / L_jj, then x_i -= L_ij y_j below it
  for (int j = 0; j < n; ++j) {
    team_sync(tm);
    const float y = x[j] * dinv[j];
    team_sync(tm);
    for (int i = j + 1 + tm.lane; i < n; i += TEAM) x[i] -= A[i][j] * y;
    if (tm.lane == 0) x[j] = y;
  }
  // backward: x_i = y_i / L_ii, then y_k -= L_ik x_i above it
  for (int i = n - 1; i >= 0; --i) {
    team_sync(tm);
    const float xi = x[i] * dinv[i];
    team_sync(tm);
    for (int k = tm.lane; k < i; k += TEAM) x[k] -= A[i][k] * xi;
    if (tm.lane == 0) x[i] = xi;
  }
  team_sync(tm);
}

// ---- staging tables into shared memory (one thread issues, all wait) ----
// Hopper's bulk asynchronous copy (cp.async.bulk, the 1-D form of the TMA)
// moves `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory and reports completion to an mbarrier. The host
// build's shim stands in for these with a memcpy.
#if defined(__CUDACC__)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(a) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy_to_shared(void* dst,
                                                    const void* src,
                                                    unsigned bytes,
                                                    uint64_t* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  const unsigned kChunk = 16384;
  for (unsigned off = 0; off < bytes; off += kChunk) {
    const unsigned n = bytes - off < kChunk ? bytes - off : kChunk;
    const unsigned d = (unsigned)__cvta_generic_to_shared((char*)dst + off);
    uint64_t g;
    asm("cvta.to.global.u64 %0, %1;"
        : "=l"(g) : "l"((unsigned long long)((const char*)src + off)));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(d), "l"(g), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(a), "r"(0u) : "memory");
  }
}
#endif
