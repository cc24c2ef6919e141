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
// phases separated by block barriers, the box QP inside it a sequence of
// pivots separated by warp barriers. The design keeps the chain short and
// simple rather than wide: ONE block; every per-step matrix lives in a
// workspace that is shared memory when it fits (RB_SMEM=1) and a global
// scratch buffer otherwise (at ndx = 128 one matrix is 64 KB); in each phase
// the threads stride over OUTPUT elements and each computes its whole dot
// product, so no phase needs a reduction across threads; the box QP, whose
// matrices are at most 32 x 64, runs on the first warp alone with warp
// barriers. Every product is written out here: no library call.
//
// Specialised at compile time: RB_NX (tangent-state size), RB_NU, RB_T
// (horizon), RB_QP_ITERS, RB_REG_TYPE (0 control, 1 state-control, 2 value,
// 3 none), RB_BLOCK (threads), RB_SMEM.
//
// Arrays are row-major: a (T-1,NX,NX), b (T-1,NX,NU), cx (T,NX), cu (T,NU),
// cxx (T,NX,NX), cxu (T,NX,NU), cuu (T,NU,NU), lo/hi (T-1,NU), reg (1);
// outputs ks (T-1,NU), kmats (T-1,NU,NX), out (3) = dv1, dv2, bad.

#include <cuda_runtime.h>
#include <math.h>

#if !defined(RB_NX) || !defined(RB_NU) || !defined(RB_T) || \
    !defined(RB_QP_ITERS) || !defined(RB_REG_TYPE) || !defined(RB_BLOCK) || \
    !defined(RB_SMEM)
#error "riccati_backward.cu needs its compile-time dimensions (see ops/riccati_lane.py)"
#endif
#define NX RB_NX
#define NU RB_NU
#define T RB_T
#define QP_ITERS RB_QP_ITERS
#define REG_TYPE RB_REG_TYPE
#define BLOCK RB_BLOCK

#define REG_CONTROL 0
#define REG_STATE_CONTROL 1
#define REG_VALUE 2
#define REG_NONE 3

// Workspace layout, in floats (ops/riccati_lane.py computes the same total).
#define W_VXX 0                          // NX x NX  value Hessian
#define W_TMP (W_VXX + NX * NX)          // NX x NX  Vxx A, then the new Vxx
#define W_QXX (W_TMP + NX * NX)          // NX x NX
#define W_VB (W_QXX + NX * NX)           // NX x NU  Vxx B
#define W_QUX (W_VB + NX * NU)           // NU x NX
#define W_QUXR (W_QUX + NU * NX)         // NU x NX  regularised
#define W_K (W_QUXR + NU * NX)           // NU x NX  gain
#define W_Z (W_K + NU * NX)              // NU x NX  Quu K
#define W_QUU (W_Z + NU * NX)            // NU x NU
#define W_QUUR (W_QUU + NU * NU)         // NU x NU  regularised
#define W_AUG (W_QUUR + NU * NU)         // NU x 2NU [masked Quu | inverse]
#define W_VX (W_AUG + 2 * NU * NU)       // NX
#define W_VXN (W_VX + NX)                // NX       new Vx
#define W_QX (W_VXN + NX)                // NX
#define W_QU (W_QX + NX)                 // NU
#define W_DU (W_QU + NU)                 // NU       box-QP iterate, then k
#define W_RHS (W_DU + NU)                // NU
#define W_FREE (W_RHS + NU)              // NU       1 free, 0 clamped
#define W_COL (W_FREE + NU)              // NU       pivot column
#define W_QUUK (W_COL + NU)              // NU       Quu k
#define W_ACC (W_QUUK + NU)              // 3        dv1, dv2, bad
#define W_TOTAL (W_ACC + 3)

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Free set of the box QP at du: a control is clamped when it sits on a
// bound and the gradient pushes it outward.
__device__ __forceinline__ void qp_free_set(const float* quur, const float* qu,
                                            const float* du, const float* lo,
                                            const float* hi, float* fre,
                                            int ln, int nl) {
  for (int u = ln; u < NU; u += nl) {
    float grad = qu[u];
    for (int v = 0; v < NU; ++v) grad += quur[u * NU + v] * du[v];
    const bool at_lo = (du[u] <= lo[u] + 1e-9f) && (grad > 0.0f);
    const bool at_hi = (du[u] >= hi[u] - 1e-9f) && (grad < 0.0f);
    fre[u] = (at_lo || at_hi) ? 0.0f : 1.0f;
  }
}

// Gauss-Jordan inverse of the masked Quu (free rows and columns kept, unit
// diagonal on clamped rows, 1e-9 jitter) into the right half of aug.
// No pivoting: the masked matrix is SPD.
__device__ __forceinline__ void qp_inverse(const float* quur, const float* fre,
                                           float* aug, float* col, int ln,
                                           int nl) {
  for (int idx = ln; idx < NU * 2 * NU; idx += nl) {
    const int u = idx / (2 * NU), c = idx % (2 * NU);
    float val;
    if (c < NU) {
      val = quur[u * NU + c] * fre[u] * fre[c];
      if (u == c) val += (1.0f - fre[u]) + 1e-9f;
    } else {
      val = (c - NU == u) ? 1.0f : 0.0f;
    }
    aug[idx] = val;
  }
  __syncwarp();
  for (int i = 0; i < NU; ++i) {
    const float piv = aug[i * 2 * NU + i];
    for (int r = ln; r < NU; r += nl) col[r] = aug[r * 2 * NU + i];
    __syncwarp();
    for (int c = ln; c < 2 * NU; c += nl) aug[i * 2 * NU + c] /= piv;
    __syncwarp();
    for (int idx = ln; idx < NU * 2 * NU; idx += nl) {
      const int r = idx / (2 * NU), c = idx % (2 * NU);
      if (r != i) aug[idx] -= col[r] * aug[i * 2 * NU + c];
    }
    __syncwarp();
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
                        float* __restrict__ out, float* scratch) {
#if RB_SMEM
  extern __shared__ float ws_shared[];
  float* ws = ws_shared;
#else
  float* ws = scratch;
#endif
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float reg = reg_in[0];
  float* vxx = ws + W_VXX;
  float* tmp = ws + W_TMP;
  float* qxx = ws + W_QXX;
  float* vb = ws + W_VB;
  float* qux = ws + W_QUX;
  float* quxr = ws + W_QUXR;
  float* kmat = ws + W_K;
  float* zmat = ws + W_Z;
  float* quu = ws + W_QUU;
  float* quur = ws + W_QUUR;
  float* aug = ws + W_AUG;
  float* vx = ws + W_VX;
  float* vxn = ws + W_VXN;
  float* qx = ws + W_QX;
  float* qu = ws + W_QU;
  float* du = ws + W_DU;
  float* rhs = ws + W_RHS;
  float* fre = ws + W_FREE;
  float* col = ws + W_COL;
  float* quuk = ws + W_QUUK;
  float* acc = ws + W_ACC;

  // terminal boundary: Vx = cx_T, Vxx = cxx_T
  for (int i = tid; i < NX * NX; i += nt)
    vxx[i] = cxx[(size_t)(T - 1) * NX * NX + i];
  for (int i = tid; i < NX; i += nt) vx[i] = cx[(T - 1) * NX + i];
  for (int i = tid; i < 3; i += nt) acc[i] = 0.0f;
  __syncthreads();

#pragma unroll 1
  for (int t = T - 2; t >= 0; --t) {
    const float* at = a + (size_t)t * NX * NX;
    const float* bt = b + (size_t)t * NX * NU;
    const float* cxt = cx + t * NX;
    const float* cut = cu + t * NU;
    const float* cxxt = cxx + (size_t)t * NX * NX;
    const float* cxut = cxu + (size_t)t * NX * NU;
    const float* cuut = cuu + t * NU * NU;
    const float* lo = du_lower + t * NU;
    const float* hi = du_upper + t * NU;

    // ---- phase 1: Vxx A, Vxx B, Qx, Qu ----
    for (int idx = tid; idx < NX * NX + NX * NU + NX + NU; idx += nt) {
      if (idx < NX * NX) {
        const int i = idx / NX, j = idx % NX;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += vxx[i * NX + k] * at[k * NX + j];
        tmp[idx] = s;
      } else if (idx < NX * NX + NX * NU) {
        const int e = idx - NX * NX;
        const int i = e / NU, u = e % NU;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += vxx[i * NX + k] * bt[k * NU + u];
        vb[e] = s;
      } else if (idx < NX * NX + NX * NU + NX) {
        const int i = idx - NX * NX - NX * NU;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += at[k * NX + i] * vx[k];
        qx[i] = cxt[i] + s;
      } else {
        const int u = idx - NX * NX - NX * NU - NX;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += bt[k * NU + u] * vx[k];
        qu[u] = cut[u] + s;
      }
    }
    __syncthreads();

    // ---- phase 2: Qxx, Qux, Quu and their regularised copies ----
    for (int idx = tid; idx < NX * NX + NU * NX + NU * NU; idx += nt) {
      if (idx < NX * NX) {
        const int i = idx / NX, j = idx % NX;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += at[k * NX + i] * tmp[k * NX + j];
        qxx[idx] = cxxt[idx] + s;
      } else if (idx < NX * NX + NU * NX) {
        const int e = idx - NX * NX;
        const int u = e / NX, j = e % NX;
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += bt[k * NU + u] * tmp[k * NX + j];
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
        const int e = idx - NX * NX - NU * NX;
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

    // ---- phase 3: box QP on the first warp ----
    {
      const int nl = nt < 32 ? nt : 32;
      if (tid < nl) {
        const int ln = tid;
        for (int u = ln; u < NU; u += nl)
          du[u] = clampf(-qu[u] / fmaxf(quur[u * NU + u], 1e-8f), lo[u],
                         hi[u]);
        __syncwarp();
#pragma unroll 1
        for (int it = 0; it <= QP_ITERS; ++it) {
          qp_free_set(quur, qu, du, lo, hi, fre, ln, nl);
          __syncwarp();
          qp_inverse(quur, fre, aug, col, ln, nl);
          if (it == QP_ITERS) break;   // final free set and its inverse
          // Newton step on the free set, clamped part in the right-hand side
          for (int u = ln; u < NU; u += nl) {
            float s = qu[u];
            for (int v = 0; v < NU; ++v)
              s += quur[u * NU + v] * (fre[v] > 0.0f ? 0.0f : du[v]);
            rhs[u] = s;
          }
          __syncwarp();
          for (int u = ln; u < NU; u += nl) {
            float s = 0.0f;
            for (int v = 0; v < NU; ++v)
              s += aug[u * 2 * NU + NU + v] * (rhs[v] * fre[v]);
            col[u] = fre[u] > 0.0f ? -(s * fre[u]) : du[u];
          }
          __syncwarp();
          for (int u = ln; u < NU; u += nl)
            du[u] = clampf(col[u], lo[u], hi[u]);
          __syncwarp();
        }
      }
    }
    __syncthreads();

    // ---- phase 4: gain on the free set, Quu k ----
    for (int idx = tid; idx < NU * NX + NU; idx += nt) {
      if (idx < NU * NX) {
        const int u = idx / NX, j = idx % NX;
        float s = 0.0f;
        for (int v = 0; v < NU; ++v)
          s += aug[u * 2 * NU + NU + v] * (quxr[v * NX + j] * fre[v]);
        const float kv = -(s * fre[u]);
        kmat[idx] = kv;
        kmats[(size_t)t * NU * NX + idx] = kv;
      } else {
        const int u = idx - NU * NX;
        float s = 0.0f;
        for (int v = 0; v < NU; ++v) s += quu[u * NU + v] * du[v];
        quuk[u] = s;
        ks[t * NU + u] = du[u];
      }
    }
    __syncthreads();

    // ---- phase 5: Quu K, the new Vx, the expected-improvement sums ----
    for (int idx = tid; idx < NU * NX + NX + 1; idx += nt) {
      if (idx < NU * NX) {
        const int u = idx / NX, j = idx % NX;
        float s = 0.0f;
        for (int v = 0; v < NU; ++v) s += quu[u * NU + v] * kmat[v * NX + j];
        zmat[idx] = s;
      } else if (idx < NU * NX + NX) {
        const int i = idx - NU * NX;
        float s1 = 0.0f, s2 = 0.0f;
        for (int u = 0; u < NU; ++u) {
          s1 += kmat[u * NX + i] * (quuk[u] + qu[u]);
          s2 += qux[u * NX + i] * du[u];
        }
        const float v = qx[i] + s1 + s2;
        vxn[i] = v;
        if (!isfinite(v)) acc[2] = 1.0f;
      } else {
        float d1 = 0.0f, d2 = 0.0f;
        bool bad = false;
        for (int u = 0; u < NU; ++u) {
          d1 += du[u] * qu[u];
          d2 += du[u] * quuk[u];
          bad = bad || !isfinite(du[u]);
        }
        acc[0] += d1;
        acc[1] += 0.5f * d2;
        if (bad) acc[2] = 1.0f;
      }
    }
    __syncthreads();

    // ---- phase 6: the new Vxx, not yet symmetric ----
    for (int idx = tid; idx < NX * NX; idx += nt) {
      const int i = idx / NX, j = idx % NX;
      float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (int u = 0; u < NU; ++u) {
        s1 += kmat[u * NX + i] * zmat[u * NX + j];
        s2 += kmat[u * NX + i] * qux[u * NX + j];
        s3 += qux[u * NX + i] * kmat[u * NX + j];
      }
      tmp[idx] = qxx[idx] + s1 + s2 + s3;
    }
    __syncthreads();

    // ---- phase 7: symmetrise, carry the value function ----
    for (int idx = tid; idx < NX * NX + NX; idx += nt) {
      if (idx < NX * NX) {
        const int i = idx / NX, j = idx % NX;
        vxx[idx] = 0.5f * (tmp[idx] + tmp[j * NX + i]);
      } else {
        vx[idx - NX * NX] = vxn[idx - NX * NX];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < 3; i += nt) out[i] = acc[i];
}

extern "C" int riccati_workspace_floats() { return W_TOTAL; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched). `scratch`
// holds riccati_workspace_floats() floats and is used when RB_SMEM is 0.
extern "C" int riccati_backward(const float* a, const float* b,
                                const float* cx, const float* cu,
                                const float* cxx, const float* cxu,
                                const float* cuu, const float* du_lower,
                                const float* du_upper, const float* reg,
                                float* ks, float* kmats, float* out,
                                float* scratch, void* stream) {
  int smem = 0;
#if RB_SMEM
  smem = W_TOTAL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      riccati_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
#endif
  riccati_backward_kernel<<<1, BLOCK, smem, (cudaStream_t)stream>>>(
      a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg, ks, kmats, out,
      scratch);
  return (int)cudaGetLastError();
}
