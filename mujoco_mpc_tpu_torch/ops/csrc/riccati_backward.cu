// iLQG backward sweep: Riccati recursion with a box QP at every step, the
// whole horizon in one launch of one thread block.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/riccati_lane.py:
// build_backward_kernel. Per step t = T-2 .. 0: the Q expansions from
// A, B, the cost derivatives and the value function (Vx, Vxx); the
// regularised copies of Quu / Qux (four regularisation types); a
// fixed-iteration projected-Newton box QP whose free-set system is inverted
// by Gauss-Jordan without pivoting (unit diagonal on clamped rows, 1e-9
// jitter); the feedforward k and the gain K on the free set; the value
// update with the UNregularised expansions; the expected-improvement sums
// dv1 = sum k'Qu, dv2 = sum 0.5 k'Quu k and a non-finite flag. Same
// arithmetic as planners/ilqg.py:backward_pass, its plain PyTorch version.
//
// Bound on an H100: neither bytes nor operations (at Swimmer's size a sweep
// reads about 0.1 MB and does about 1 Mflop, microseconds of either) but
// the length of the dependent chain: T-1 steps, each a fixed sequence of
// phases, the box QP inside it a sequence of pivots. Measured on the
// card's clock (RB_PROFILE): the box QP took 89% of a step at ndx 16, nu 5
// when it ran through shared memory with three warp barriers a pivot. The
// design:
//  * one block; the workspace (Vxx, then Qxx, then the new Vxx in one
//    buffer, Vxx A beside it, the smaller matrices) lives in shared memory
//    at every size of the gate (227 KB at ndx 128, nu 32); each step's
//    inputs are read from global memory where a phase uses them (staging
//    them ahead into shared memory by bulk asynchronous copies gained
//    nothing measurable: the QP, not the reads, is the chain);
//  * the box QP runs in the registers of one warp: lane u holds row u of
//    the masked Quu and of its inverse (rows u, u + lanes, .. when NU is
//    larger than the lanes), the pivot row reaches the other lanes by
//    __shfl_sync, with no shared memory and no barrier inside the pivot
//    loop; the same warp then forms Quu k, the expected-improvement sums
//    and P = Quu F inv (F the free set's 0/1 diagonal), so that the gain
//    K = -F inv F Qux_reg and Quu K = -P F Qux_reg are both NU-long dot
//    products of one block phase;
//  * five block barriers a step: after Vxx A (phase 1), after the Q
//    expansions (2), after the QP warp (3), after K and Quu K (4), after
//    the new Vx and the symmetric new Vxx, each of whose (i, j) / (j, i)
//    pairs one thread computes and writes (5); in each block phase the
//    threads stride over OUTPUT elements and each computes its whole dot
//    product, so no phase reduces across threads.
// Every product is written out here: no library call.
//
// Specialised at compile time: RB_NX (tangent-state size), RB_NU, RB_T
// (horizon), RB_QP_ITERS, RB_REG_TYPE (0 control, 1 state-control, 2 value,
// 3 none), RB_BLOCK (threads), RB_QP_LANES (lanes of the QP warp, 32; the
// host build of the source runs 1), RB_PROFILE (a measuring build:
// clock64() stamps, see below).
//
// Arrays are row-major: a (T-1,NX,NX), b (T-1,NX,NU), cx (T,NX), cu (T,NU),
// cxx (T,NX,NX), cxu (T,NX,NU), cuu (T,NU,NU), lo/hi (T-1,NU), reg (1);
// outputs ks (T-1,NU), kmats (T-1,NU,NX), out (3) = dv1, dv2, bad.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(RB_NX) || !defined(RB_NU) || !defined(RB_T) || \
    !defined(RB_QP_ITERS) || !defined(RB_REG_TYPE) || !defined(RB_BLOCK)
#error "riccati_backward.cu needs its compile-time dimensions (see ops/riccati_lane.py)"
#endif
#ifndef RB_QP_LANES
#define RB_QP_LANES 32
#endif
#ifndef RB_PROFILE
#define RB_PROFILE 0
#endif
#if RB_QP_LANES > RB_BLOCK
#error "the QP warp's lanes are threads of the block"
#endif

#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

#define NX RB_NX
#define NU RB_NU
#define T RB_T
#define QP_ITERS RB_QP_ITERS
#define REG_TYPE RB_REG_TYPE
#define BLOCK RB_BLOCK
#define QPL RB_QP_LANES
#define QROWS ((NU + QPL - 1) / QPL)      // QP rows a lane

// the NX x NX products of phases 1 and 2: RT rows a thread (one column),
// each operand of the other factor loaded once for the RT rows
#define RT (NX % 4 == 0 ? 4 : 1)
#define TILES (NX * NX / RT)

#define REG_CONTROL 0
#define REG_STATE_CONTROL 1
#define REG_VALUE 2
#define REG_NONE 3

// RB_PROFILE=1 (a measuring build, launched by no path): thread 0 stamps
// clock64() at the step's start, after each of the first two barriers, when
// its box QP is done, and after each of the last three barriers, into
// prof[(T-2-t) * RB_STAMPS + i].
#define RB_STAMPS 7
#if RB_PROFILE
#define RB_STAMP(t, i) \
  if (tid == 0) prof[(size_t)(T - 2 - (t)) * RB_STAMPS + (i)] = clock64()
#else
#define RB_STAMP(t, i)
#endif

// Workspace layout, in floats (ops/riccati_lane.py computes the same total).
#define INV_LD (NU | 1)                  // odd: a lane a row, distinct banks
#define W_X 0                            // NX x NX  Vxx, Qxx, the new Vxx
#define W_Y (W_X + NX * NX)              // NX x NX  Vxx A
#define W_VB (W_Y + NX * NX)             // NX x NU  Vxx B
#define W_QUX (W_VB + NX * NU)           // NU x NX
#define W_QUXR (W_QUX + NU * NX)         // NU x NX  regularised
#define W_K (W_QUXR + NU * NX)           // NU x NX  gain
#define W_Z (W_K + NU * NX)              // NU x NX  Quu K
#define W_QUU (W_Z + NU * NX)            // NU x NU
#define W_QUUR (W_QUU + NU * NU)         // NU x NU  regularised; after the
                                         //   QP, P = Quu F inv in its place
#define W_INV (W_QUUR + NU * NU)         // NU x INV_LD  inverse of the QP
#define W_VX (W_INV + NU * INV_LD)       // 2 NX     Vx, by the step's parity
#define W_QX (W_VX + 2 * NX)             // NX
#define W_QU (W_QX + NX)                 // NU
#define W_DU (W_QU + NU)                 // NU       k
#define W_FREE (W_DU + NU)               // NU       1 free, 0 clamped
#define W_QUUK (W_FREE + NU)             // NU       Quu k
#define W_BAD (W_QUUK + NU)              // 1        a non-finite k or Vx
#define W_TOTAL (W_BAD + 1)
#define SMEM_BYTES ((unsigned)(W_TOTAL * sizeof(float)))

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---- the box QP in the registers of the QP warp ----
// Row v of Quu (the free set, the Newton step) lives on lane v % QPL in
// slot v / QPL; column c of [masked Quu | I] (the Gauss-Jordan
// elimination) on lane c % QPL in slot c / QPL. BCAST gives every lane the
// value of a per-row array that row v's lane holds.
#define QP_MASK 0xffffffffu
#define CSLOTS ((2 * NU + QPL - 1) / QPL)  // columns of [M | I] a lane
#define BCAST(arr, v) __shfl_sync(QP_MASK, (arr)[(v) / QPL], (v) % QPL, QPL)

// Free set at du: a control is clamped when it sits on a bound and the
// gradient pushes it outward. This lane's rows in fre, every row in frea.
__device__ __forceinline__ void qp_free_set(const float (&qr)[QROWS][NU],
                                            const float* quv,
                                            const float* du,
                                            const float* dua,
                                            const float* lov,
                                            const float* hiv, float* fre,
                                            float* frea) {
#pragma unroll
  for (int q = 0; q < QROWS; ++q) {
    float grad = quv[q];
#pragma unroll
    for (int v = 0; v < NU; ++v) grad += qr[q][v] * dua[v];
    const bool at_lo = (du[q] <= lov[q] + 1e-9f) && (grad > 0.0f);
    const bool at_hi = (du[q] >= hiv[q] - 1e-9f) && (grad < 0.0f);
    fre[q] = (at_lo || at_hi) ? 0.0f : 1.0f;
  }
#pragma unroll
  for (int v = 0; v < NU; ++v) frea[v] = BCAST(fre, v);
}

// Gauss-Jordan inverse of the masked Quu (free rows and columns kept, unit
// diagonal on clamped rows, 1e-9 jitter), no pivoting (the masked matrix is
// SPD), into w_inv (row stride INV_LD). Each lane eliminates its columns of
// [M | I]: per pivot i the column-i factors come from column i's lane by
// shuffles (one a row), the lane divides its own entry of row i by the
// pivot and subtracts factor times quotient from its other entries: the
// shared-memory form's arithmetic, entry by entry, with no barrier.
__device__ __forceinline__ void qp_inverse(int lane, const float* quur,
                                           const float* fre,
                                           const float* frea,
                                           float (&aug)[CSLOTS][NU],
                                           float* w_inv) {
#pragma unroll
  for (int sl = 0; sl < CSLOTS; ++sl) {
    const int c = lane + sl * QPL;
    // a column of M is a row of Quu: the same lane and slot hold its flag
    const float fc = c < NU ? fre[sl < QROWS ? sl : 0] : 0.0f;
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      float val;
      if (c < NU) {
        val = quur[r * NU + c] * frea[r] * fc;
        if (r == c) val += (1.0f - frea[r]) + 1e-9f;
      } else {
        val = (c - NU == r) ? 1.0f : 0.0f;
      }
      aug[sl][r] = val;
    }
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float colf[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r)
      colf[r] = __shfl_sync(QP_MASK, aug[i / QPL][r], i % QPL, QPL);
#pragma unroll
    for (int sl = 0; sl < CSLOTS; ++sl) {
      const float x = aug[sl][i] / colf[i];
#pragma unroll
      for (int r = 0; r < NU; ++r)
        aug[sl][r] = r == i ? x : aug[sl][r] - colf[r] * x;
    }
  }
#pragma unroll
  for (int sl = 0; sl < CSLOTS; ++sl) {
    const int c = lane + sl * QPL;
    if (c >= NU && c < 2 * NU) {
#pragma unroll
      for (int r = 0; r < NU; ++r) w_inv[r * INV_LD + (c - NU)] = aug[sl][r];
    }
  }
}

// The box QP of one step on the QP warp (lanes 0 .. QPL-1): from the
// regularised Quu and Qu in shared memory and the step's bounds, leaves k
// in w_du, the final free set in w_fre and its inverse in w_inv.
__device__ __forceinline__ void box_qp(int lane, const float* quur,
                                       const float* qu, const float* lo,
                                       const float* hi, float* w_du,
                                       float* w_fre, float* w_inv) {
  float qr[QROWS][NU], aug[CSLOTS][NU];
  float quv[QROWS], lov[QROWS], hiv[QROWS], du[QROWS], fre[QROWS];
  float dua[NU], frea[NU];
#pragma unroll
  for (int q = 0; q < QROWS; ++q) {
    const int u = lane + q * QPL < NU ? lane + q * QPL : NU - 1;
    float diag = 0.0f;
#pragma unroll
    for (int v = 0; v < NU; ++v) {
      qr[q][v] = quur[u * NU + v];
      if (v == u) diag = qr[q][v];
    }
    quv[q] = qu[u];
    lov[q] = lo[u];
    hiv[q] = hi[u];
    du[q] = clampf(-quv[q] / fmaxf(diag, 1e-8f), lov[q], hiv[q]);
  }
#pragma unroll
  for (int v = 0; v < NU; ++v) dua[v] = BCAST(du, v);
#pragma unroll 1
  for (int it = 0; it <= QP_ITERS; ++it) {
    qp_free_set(qr, quv, du, dua, lov, hiv, fre, frea);
    qp_inverse(lane, quur, fre, frea, aug, w_inv);
    __syncwarp();
    if (it == QP_ITERS) break;   // final free set and its inverse
    // Newton step on the free set, the clamped part in the right-hand side
    float rhs[QROWS], step[QROWS];
#pragma unroll
    for (int q = 0; q < QROWS; ++q) {
      float s = quv[q];
#pragma unroll
      for (int v = 0; v < NU; ++v)
        s += qr[q][v] * (frea[v] > 0.0f ? 0.0f : dua[v]);
      rhs[q] = s;
      step[q] = 0.0f;
    }
#pragma unroll
    for (int v = 0; v < NU; ++v) {
      const float r = BCAST(rhs, v) * frea[v];
#pragma unroll
      for (int q = 0; q < QROWS; ++q) {
        const int u = lane + q * QPL < NU ? lane + q * QPL : NU - 1;
        step[q] += w_inv[u * INV_LD + v] * r;
      }
    }
    __syncwarp();   // every lane has read the inverse the next one replaces
#pragma unroll
    for (int q = 0; q < QROWS; ++q)
      du[q] = clampf(fre[q] > 0.0f ? -(step[q] * fre[q]) : du[q], lov[q],
                     hiv[q]);
#pragma unroll
    for (int v = 0; v < NU; ++v) dua[v] = BCAST(du, v);
  }
#pragma unroll
  for (int q = 0; q < QROWS; ++q) {
    const int u = lane + q * QPL;
    if (u < NU) {
      w_du[u] = du[q];
      w_fre[u] = fre[q];
    }
  }
}

extern "C" __global__ void __launch_bounds__(BLOCK)
riccati_backward_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ cx,
                        const float* __restrict__ cu,
                        const float* __restrict__ cxx,
                        const float* __restrict__ cxu,
                        const float* __restrict__ cuu,
                        const float* __restrict__ du_lower,
                        const float* __restrict__ du_upper,
                        const float* __restrict__ reg_in,
                        float* __restrict__ ks, float* __restrict__ kmats,
                        float* __restrict__ out, long long* prof) {
  DYNAMIC_SMEM(smem_raw);
  float* ws = (float*)smem_raw;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float reg = reg_in[0];
  float* xm = ws + W_X;
  float* ym = ws + W_Y;
  float* vb = ws + W_VB;
  float* qux = ws + W_QUX;
  float* quxr = ws + W_QUXR;
  float* kmat = ws + W_K;
  float* zmat = ws + W_Z;
  float* quu = ws + W_QUU;
  float* quur = ws + W_QUUR;
  float* pmat = ws + W_QUUR;
  float* inv = ws + W_INV;
  float* qx = ws + W_QX;
  float* qu = ws + W_QU;
  float* du = ws + W_DU;
  float* fre = ws + W_FREE;
  float* quuk = ws + W_QUUK;
  // the QP warp's lane 0 carries dv1 and dv2 over the steps
  float acc1 = 0.0f, acc2 = 0.0f;

  // terminal boundary: Vx = cx_T, Vxx = cxx_T
  for (int i = tid; i < NX * NX; i += nt)
    xm[i] = cxx[(size_t)(T - 1) * NX * NX + i];
  for (int i = tid; i < NX; i += nt) ws[W_VX + i] = cx[(T - 1) * NX + i];
  if (tid == 0) ws[W_BAD] = 0.0f;
  __syncthreads();

#pragma unroll 1
  for (int n = 0; n < T - 1; ++n) {
    const int t = T - 2 - n;
    const float* vx = ws + W_VX + (n & 1) * NX;
    float* vxn = ws + W_VX + ((n + 1) & 1) * NX;
    const float* at = a + (size_t)t * NX * NX;
    const float* bt = b + (size_t)t * NX * NU;
    const float* cxt = cx + (size_t)t * NX;
    const float* cut = cu + (size_t)t * NU;
    const float* cxxt = cxx + (size_t)t * NX * NX;
    const float* cxut = cxu + (size_t)t * NX * NU;
    const float* cuut = cuu + (size_t)t * NU * NU;
    const float* lo = du_lower + (size_t)t * NU;
    const float* hi = du_upper + (size_t)t * NU;
    RB_STAMP(t, 0);

    // ---- phase 1: Vxx A (RT rows a thread), Vxx B, Qx, Qu ----
    for (int idx = tid; idx < TILES + NX * NU + NX + NU; idx += nt) {
      if (idx < TILES) {
        const int i0 = idx / NX * RT, j = idx % NX;
        float s[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) s[r] = 0.0f;
        for (int k = 0; k < NX; ++k) {
          const float av = at[k * NX + j];
#pragma unroll
          for (int r = 0; r < RT; ++r) s[r] += xm[(i0 + r) * NX + k] * av;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) ym[(i0 + r) * NX + j] = s[r];
      } else if (idx < TILES + NX * NU) {
        const int e = idx - TILES;
        const int i = e / NU, u = e % NU;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += xm[i * NX + k] * bt[k * NU + u];
        vb[e] = s;
      } else if (idx < TILES + NX * NU + NX) {
        const int i = idx - TILES - NX * NU;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += at[k * NX + i] * vx[k];
        qx[i] = cxt[i] + s;
      } else {
        const int u = idx - TILES - NX * NU - NX;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += bt[k * NU + u] * vx[k];
        qu[u] = cut[u] + s;
      }
    }
    __syncthreads();
    RB_STAMP(t, 1);

    // ---- phase 2: Qxx (over Vxx), Qux, Quu and their regularised copies --
    for (int idx = tid; idx < TILES + NU * NX + NU * NU; idx += nt) {
      if (idx < TILES) {
        const int i0 = idx / NX * RT, j = idx % NX;
        float s[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) s[r] = 0.0f;
        for (int k = 0; k < NX; ++k) {
          const float yv = ym[k * NX + j];
#pragma unroll
          for (int r = 0; r < RT; ++r) s[r] += at[k * NX + i0 + r] * yv;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
          xm[(i0 + r) * NX + j] = cxxt[(i0 + r) * NX + j] + s[r];
      } else if (idx < TILES + NU * NX) {
        const int e = idx - TILES;
        const int u = e / NX, j = e % NX;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += bt[k * NU + u] * ym[k * NX + j];
        const float q = cxut[j * NU + u] + s;
        qux[e] = q;
        if (REG_TYPE == REG_STATE_CONTROL || REG_TYPE == REG_VALUE) {
          // Qux + reg B'A (value regularisation: B'(Vxx + reg I)A)
          float r = 0.0f;
          for (int k = 0; k < NX; ++k) r += bt[k * NU + u] * at[k * NX + j];
          quxr[e] = q + reg * r;
        } else {
          quxr[e] = q;
        }
      } else {
        const int e = idx - TILES - NU * NX;
        const int u = e / NU, v = e % NU;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += bt[k * NU + u] * vb[k * NU + v];
        const float q = cuut[e] + s;
        quu[e] = q;
        if (REG_TYPE == REG_STATE_CONTROL || REG_TYPE == REG_VALUE) {
          float r = 0.0f;
          for (int k = 0; k < NX; ++k) r += bt[k * NU + u] * bt[k * NU + v];
          quur[e] = q + reg * r;
        } else if (REG_TYPE == REG_CONTROL) {
          quur[e] = q + (u == v ? reg : 0.0f);
        } else {
          quur[e] = q + (u == v ? 1e-9f : 0.0f);
        }
      }
    }
    __syncthreads();
    RB_STAMP(t, 2);

    // ---- phase 3, the QP warp: box QP; then Quu k, k out, P = Quu F inv
    // (over the regularised Quu, which the QP no longer reads) and the
    // expected-improvement sums ----
    if (tid < QPL) {
      const int ln = tid;
      box_qp(ln, quur, qu, lo, hi, du, fre, inv);
      RB_STAMP(t, 3);
      __syncwarp();
      for (int idx = ln; idx < NU * NU + NU; idx += QPL) {
        if (idx < NU * NU) {
          const int u = idx / NU, v = idx % NU;
          float s = 0.0f;
          for (int w = 0; w < NU; ++w)
            s += quu[u * NU + w] * (fre[w] * inv[w * INV_LD + v]);
          pmat[idx] = s;
        } else {
          const int u = idx - NU * NU;
          float s = 0.0f;
          for (int v = 0; v < NU; ++v) s += quu[u * NU + v] * du[v];
          quuk[u] = s;
          ks[t * NU + u] = du[u];
        }
      }
      __syncwarp();
      if (ln == 0) {
        float d1 = 0.0f, d2 = 0.0f;
        bool bad = false;
        for (int u = 0; u < NU; ++u) {
          d1 += du[u] * qu[u];
          d2 += du[u] * quuk[u];
          bad = bad || !isfinite(du[u]);
        }
        acc1 += d1;
        acc2 += 0.5f * d2;
        if (bad) ws[W_BAD] = 1.0f;
      }
    }
    __syncthreads();
    RB_STAMP(t, 4);

    // ---- phase 4: the gain K = -F inv F Qux_reg on the free set, and
    // Quu K = -P F Qux_reg ----
    for (int idx = tid; idx < 2 * NU * NX; idx += nt) {
      const int e = idx < NU * NX ? idx : idx - NU * NX;
      const int u = e / NX, j = e % NX;
      float s = 0.0f;
      if (idx < NU * NX) {
        for (int v = 0; v < NU; ++v)
          s += inv[u * INV_LD + v] * (quxr[v * NX + j] * fre[v]);
        const float kv = -(s * fre[u]);
        kmat[e] = kv;
        kmats[(size_t)t * NU * NX + e] = kv;
      } else {
        for (int v = 0; v < NU; ++v)
          s += pmat[u * NU + v] * (quxr[v * NX + j] * fre[v]);
        zmat[e] = -s;
      }
    }
    __syncthreads();
    RB_STAMP(t, 5);

    // ---- phase 5: the new Vx (Qx + K'(Quu k + Qu) + Qux'k) and the new
    // Vxx, symmetric: one thread a pair (i, j >= i) computes both entries
    // (Qxx + K'Quu K + K'Qux + Qux'K) and writes their mean to both; pairs
    // folded two rows a fold (rows f and NX-1-f), NX + 1 entries a fold ----
    for (int q = tid; q < NX * (NX + 1) / 2 + NX; q += nt) {
      if (q >= NX * (NX + 1) / 2) {
        const int i = q - NX * (NX + 1) / 2;
        float s1 = 0.0f, s2 = 0.0f;
        for (int u = 0; u < NU; ++u) {
          s1 += kmat[u * NX + i] * (quuk[u] + qu[u]);
          s2 += qux[u * NX + i] * du[u];
        }
        const float v = qx[i] + s1 + s2;
        vxn[i] = v;
        if (!isfinite(v)) ws[W_BAD] = 1.0f;
        continue;
      }
      const int f = q / (NX + 1), c = q % (NX + 1);
      const int i = c <= f ? f : NX - 1 - f;
      const int j = c <= f ? c : c - f - 1;
      float e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? j : i, cc = h ? i : j;
        float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (int u = 0; u < NU; ++u) {
          s1 += kmat[u * NX + r] * zmat[u * NX + cc];
          s2 += kmat[u * NX + r] * qux[u * NX + cc];
          s3 += qux[u * NX + r] * kmat[u * NX + cc];
        }
        e[h] = xm[r * NX + cc] + s1 + s2 + s3;
      }
      const float v = 0.5f * (e[0] + e[1]);
      xm[i * NX + j] = v;
      xm[j * NX + i] = v;
    }
    __syncthreads();
    RB_STAMP(t, 6);
  }
  if (tid == 0) {
    out[0] = acc1;
    out[1] = acc2;
    out[2] = ws[W_BAD];
  }
}

extern "C" int riccati_workspace_floats() { return W_TOTAL; }
extern "C" int riccati_profile_stamps() { return RB_PROFILE ? RB_STAMPS : 0; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched). `prof`
// holds (T-1) * riccati_profile_stamps() stamps in a profiling build (else
// it may be null).
extern "C" int riccati_backward(const float* a, const float* b,
                                const float* cx, const float* cu,
                                const float* cxx, const float* cxu,
                                const float* cuu, const float* du_lower,
                                const float* du_upper, const float* reg,
                                float* ks, float* kmats, float* out,
                                long long* prof, void* stream) {
  const int smem = (int)SMEM_BYTES;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int threads = BLOCK;
  riccati_backward_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg, ks, kmats, out,
      prof);
  return (int)cudaGetLastError();
}
