// Lane rollout kernel: K candidate rollouts over the whole horizon in one
// launch, one thread per candidate.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/step_lane.py:
// build_rollout_kernel. Per horizon step and candidate: forward kinematics,
// com quantities, composite-inertia mass matrix, RNE bias, passive forces,
// (springs, dampers, the inertia-box fluid model), joint-transmission
// actuation, the task residual on the pre-step state,
// joint-limit rows and plane-sphere contacts (pyramidal rows, condim-1 rows
// or elliptic cone blocks), Newton on the acceleration with a safeguarded
// exact line search, implicit-damping Euler with quaternion integration.
//
// One generic source. A build specialises it with compile-time dimensions
// (-DLR_NQ=.. etc., listed below) and one task-residual header
// (-DRESIDUAL_HEADER=...). Everything else about the model — tree tables,
// body/joint/actuator constants, limit rows, per-contact frames and solver
// parameters, the task's constants — is data in two __constant__ structs
// (`TablesHead tb`, `TaskConst task_tb`) filled by the wrapper
// (ops/step_lane.py packs the same field order). Candidates are the last, contiguous axis of every
// array, so global loads and stores are coalesced.
//
// Bound on an H100: the latency of one long sequential per-thread program;
// the launch moves only a few megabytes. At the flagship's 4096 candidates
// an SM holds ONE warp, so nothing hides a load behind another warp's work:
// the hot loops (elliptic blocks, Cholesky) have compile-time bounds and
// unroll into straight-line code whose loads issue ahead of their use. The
// instruction cache is the budget for that: the loops over contacts stay
// rolled (unrolling them was measured slower). The nv x nv matrices are
// indexed by loop variables and live in thread-local memory.
//
// Control (LR_CTRL): 0 = zero-order-hold spline nodes, one column of
// `values` (P*NU, K) per candidate; 1 = the feedback law of iLQG's line
// searches, u = clip(u_nom[t] + alpha k[t] + scale K[t] dx, ctrlrange), with
// alpha = values[0], scale = values[1] per candidate, dx the tangent
// difference to the nominal state, and `table` (H, STRIDE) the per-step
// blocks [u_nom, k, K row-major, x_nom] shared by all candidates: every
// thread of a warp reads the same address, through the read-only path.
//
// MODE 0: out0 = states (H, NQ+NV+NR, K), pre-step state (+ residual rows)
// MODE 1: out0 = residual rows (H, NR, K), out1 = final state (NQ+NV, K)
// MODE 2: out0 = per-term cost sums (NTERM, K), out1 = final state

#include <cuda_runtime.h>
#include <math.h>

// Dimensions arrive as LR_* macros (prefixed so that no system header sees
// a one-letter macro) and get their short names only after the includes.
#if !defined(LR_NQ) || \
    !defined(LR_NV) || \
    !defined(LR_NU) || \
    !defined(LR_NBODY) || \
    !defined(LR_NJNT) || \
    !defined(LR_NLIMJ) || \
    !defined(LR_NCON) || \
    !defined(LR_NPROW) || \
    !defined(LR_NECON) || \
    !defined(LR_NSUP) || \
    !defined(LR_H) || \
    !defined(LR_P) || \
    !defined(LR_NAUX) || \
    !defined(LR_NTERM) || \
    !defined(LR_NR) || \
    !defined(LR_N_NEWTON) || \
    !defined(LR_N_LS) || \
    !defined(LR_MODE) || \
    !defined(LR_CONE) || \
    !defined(LR_BLOCK) || \
    !defined(LR_EROWS) || \
    !defined(LR_PROFILE) || \
    !defined(LR_CTRL) || \
    !defined(LR_FLUID) || \
    !defined(RESIDUAL_HEADER)
#error "lane_rollout.cu needs its compile-time dimensions (see ops/step_lane.py)"
#endif
#define NQ LR_NQ
#define NV LR_NV
#define NU LR_NU
#define NBODY LR_NBODY
#define NJNT LR_NJNT
#define NLIMJ LR_NLIMJ
#define NCON LR_NCON
#define NPROW LR_NPROW
#define NECON LR_NECON
#define NSUP LR_NSUP
#define H LR_H
#define P LR_P
#define NAUX LR_NAUX
#define NTERM LR_NTERM
#define NR LR_NR
#define N_NEWTON LR_N_NEWTON
#define N_LS LR_N_LS
#define MODE LR_MODE
#define CONE LR_CONE
#define BLOCK LR_BLOCK
#define EROWS LR_EROWS
#define PROFILE LR_PROFILE
#define CTRL LR_CTRL
#define FLUID LR_FLUID

#define D1(n) ((n) > 0 ? (n) : 1)
#define NLIM (2 * (NLIMJ))
#define NAUXK ((NAUX) + 2 * (NTERM))
#define HAS_ROWS ((NLIMJ) > 0 || (NCON) > 0)
#define NDX (2 * (NV))
#define STRIDE (2 * (NU) + (NU) * NDX + (NQ) + (NV))

#define JNT_FREE 0
#define JNT_SLIDE 2
#define JNT_HINGE 3

#include "lane_math.cuh"

struct StepCtx {
  const float* qpos;
  const float* qvel;
  const float* ctrl;
  const float (*xpos)[3];
  const float (*xquat)[4];
  const float (*xipos)[3];
  const float (*subtree_com)[3];  // ref of body b: subtree_com[body_rootid[b]]
  const float (*cvel)[6];         // angular 0..2, linear 3..5, about ref
  const float* act_force;
  const float* aux;
  int t;
};

// Field order and padded shapes mirror _pack_tables in ops/step_lane.py.
// All members are 4 bytes wide, so the struct has no padding.
struct TablesHead {
  int body_parentid[NBODY];
  int body_rootid[NBODY];
  int body_jntadr[NBODY];
  int body_jntnum[NBODY];
  int body_dofadr[NBODY];
  int body_dofnum[NBODY];
  int jnt_type[D1(NJNT)];
  int jnt_qposadr[D1(NJNT)];
  int jnt_dofadr[D1(NJNT)];
  int jnt_bodyid[D1(NJNT)];
  int dof_bodyid[D1(NV)];
  int dof_jntid[D1(NV)];
  int dof_anc[D1(NV)][D1(NV)];   // symmetric: j on the path of i or i of j
  int act_qadr[D1(NU)];
  int act_dadr[D1(NU)];
  int act_gainfixed[D1(NU)];
  int act_hasbias[D1(NU)];
  int act_ctrllimited[D1(NU)];
  int act_forcelimited[D1(NU)];
  int lim_qadr[D1(NLIMJ)];
  int lim_dadr[D1(NLIMJ)];
  int con_body[D1(NCON)];
  int con_condim[D1(NCON)];
  int con_nsup[D1(NCON)];
  int con_sup[D1(NCON)][D1(NSUP)];
  int prow_con[D1(NPROW)];
  int econ_con[D1(NECON)];
  int term_type[D1(NTERM)];
  int term_dim[D1(NTERM)];
  int body_dofmask[NBODY][D1(NV)];  // dof moves the body
  int fluid_on[NBODY];              // body takes fluid forces
  float timestep[1];
  float gravity[3];
  float body_pos[NBODY][3];
  float body_quat[NBODY][4];
  float body_ipos[NBODY][3];
  float body_iquat[NBODY][4];
  float body_mass[NBODY];
  float body_inertia[NBODY][3];
  float body_invsubtreemass[NBODY];
  float jnt_pos[D1(NJNT)][3];
  float jnt_axis[D1(NJNT)][3];
  float jnt_stiffness[D1(NJNT)];
  float qpos0[D1(NQ)];
  float qpos_spring[D1(NQ)];
  float dof_damping[D1(NV)];
  float dof_hdamping[D1(NV)];    // timestep * damping
  float dof_armature[D1(NV)];
  float act_gear[D1(NU)];
  float act_gainprm[D1(NU)][3];
  float act_biasprm[D1(NU)][3];
  float act_ctrlrange[D1(NU)][2];
  float act_forcerange[D1(NU)][2];
  float lim_lo[D1(NLIMJ)];
  float lim_hi[D1(NLIMJ)];
  float lim_margin[D1(NLIMJ)];
  float lim_invw[D1(NLIMJ)];
  float lim_imp[D1(NLIMJ)][9];
  float con_geompos[D1(NCON)][3];
  float con_radius[D1(NCON)];
  float con_planepos[D1(NCON)][3];
  float con_dirs[D1(NCON)][3][3];  // normal, tangent 1, tangent 2
  float con_imp[D1(NCON)][9];
  float con_incm[D1(NCON)];
  float con_invw[D1(NCON)];        // clamped at 1e-12
  float con_iw[D1(NCON)];          // pyramidal diagonal, clamped at 1e-12
  float con_mu[D1(NCON)];          // elliptic mu_eff
  float con_1pmu2[D1(NCON)];       // 1 + mu_eff^2
  float con_scales[D1(NCON)][5];
  float con_scales2[D1(NCON)][5];
  float prow_smu[D1(NPROW)];       // sign * friction of the row's axis
  float wind[3];
  float fluid_visc[NBODY][2];      // viscous torque, force coefficients
  float fluid_dens_f[NBODY][3];    // quadratic-drag force, per local axis
  float fluid_dens_t[NBODY][3];    // quadratic-drag torque, per local axis
};

// impedance constant block: d0 dmax width mid power a_c b_c b_coef k_coef
#define IMP_B 7
#define IMP_K 8

// Generic tables, then the task's constant block: the residual header
// defines TaskConst and reads the generic tables through `tb`.
__constant__ TablesHead tb;

#define LR_STR2(x) #x
#define LR_STR(x) LR_STR2(x)
#include LR_STR(RESIDUAL_HEADER)

__constant__ TaskConst task_tb;

__device__ __forceinline__ float impedance(float pos, const float* ic) {
  const float x = clampf(fabsf(pos) / ic[2], 0.0f, 1.0f);
  // power 2 (the default) as a product, as the array libraries do
  const float y = ic[4] == 2.0f
      ? (x <= ic[3] ? ic[5] * (x * x) : 1.0f - ic[6] * ((1.0f - x) * (1.0f - x)))
      : (x <= ic[3] ? ic[5] * powf(x, ic[4])
                    : 1.0f - ic[6] * powf(1.0f - x, ic[4]));
  return clampf(ic[0] + y * (ic[1] - ic[0]), 1e-4f, 0.9999f);
}

// Reference acceleration and gated stiffness of a one-sided row.
__device__ __forceinline__ void kbi(float pos, float jv, const float* ic,
                                    float invw, float* aref, float* dcoef) {
  const float imp = impedance(pos, ic);
  *aref = -ic[IMP_B] * jv - ic[IMP_K] * imp * pos;
  const float r_reg = fmaxf((1.0f - imp) / imp * invw, 1e-12f);
  *dcoef = pos < 0.0f ? 1.0f / r_reg : 0.0f;
}

// Unweighted norm value of one residual slice (costs/norms.py).
__device__ float term_cost(const float* r, int dim, int type, float p,
                           float q) {
  const float eps = 1e-15f;
  float s = 0.0f;
  switch (type) {
    case -1:  // NULL
      return r[0];
    case 0:   // QUADRATIC
      for (int i = 0; i < dim; ++i) s += r[i] * r[i];
      return 0.5f * s;
    case 1: { // L22
      for (int i = 0; i < dim; ++i) s += r[i] * r[i];
      const float c = fmaxf(s, eps);
      const float a = powf(c, q / 2) + powf(p, q);
      return powf(a, 1.0f / q) - p;
    }
    case 2:   // L2
      for (int i = 0; i < dim; ++i) s += r[i] * r[i];
      return sqrtf(s + p * p) - p;
    case 3:   // COSH
      for (int i = 0; i < dim; ++i) s += p * p * (coshf(r[i] / p) - 1.0f);
      return s;
    case 5:   // POWER_LOSS
      for (int i = 0; i < dim; ++i) s += powf(fabsf(r[i]), p);
      return s;
    case 6:   // SMOOTH_ABS
      for (int i = 0; i < dim; ++i) s += sqrtf(r[i] * r[i] + p * p) - p;
      return s;
    case 7:   // SMOOTH_ABS2
      for (int i = 0; i < dim; ++i)
        s += powf(powf(fabsf(r[i]), q) + powf(p, q), 1.0f / q) - p;
      return s;
    case 8:   // RECTIFY
      for (int i = 0; i < dim; ++i)
        s += p > 0.0f ? p * log1pf(expf(r[i] / fmaxf(p, eps)))
                      : fmaxf(r[i], 0.0f);
      return s;
  }
  return 0.0f;
}

// Elliptic cone cost expansion at jar (normal row 0, friction rows 1..nf).
// Zones in the scaled space s_i = jar_i * scale_i, t = ||s||: bottom
// (mu*n + t <= 0) full quadratic; top (n >= mu*t) zero force; middle convex
// cost 0.5*D_N/(1+mu^2)*(n - mu t)^2 with the exact cone Hessian
// (diag + w_mid gz gz^T - w_cone cs cs^T).
struct EllTerms {
  float g[EROWS];
  float hd[EROWS];
  float gz[EROWS];
  float cs[EROWS];
  float w_mid;
  float w_cone;
};

__device__ __forceinline__ void ell_terms(const float* jar, float dn, int ci,
                                          EllTerms* o) {
  // Every block carries EROWS rows (the largest condim among the elliptic
  // contacts); a contact of lower condim has zero rows and zero scales
  // beyond its own, which add exact zeros, so the loops have fixed bounds.
  constexpr int nf = EROWS - 1;
  const float mu = tb.con_mu[ci];
  const float* scales = tb.con_scales[ci];
  const float n_ = jar[0];
  float srow[D1(EROWS - 1)];
  float tt = 0.0f;
#pragma unroll
  for (int i = 0; i < nf; ++i) {
    srow[i] = jar[1 + i] * scales[i];
    tt += srow[i] * srow[i];
  }
  const float t = sqrtf(tt);
  const float tsafe = fmaxf(t, 1e-12f);
  const bool bottom = (mu * n_ + t) <= 0.0f;
  const bool middle = !bottom && (n_ < mu * t);
  const float w_coef = dn / tb.con_1pmu2[ci];
  const float z = n_ - mu * t;
  const float wz = middle ? w_coef * z : 0.0f;
  const float d_act = bottom ? dn : 0.0f;
  o->w_cone = middle ? w_coef * (-z) * mu / tsafe : 0.0f;
  o->w_mid = middle ? w_coef : 0.0f;
  o->gz[0] = 1.0f;
  o->cs[0] = 0.0f;
  o->g[0] = d_act * jar[0] + wz;
  o->hd[0] = d_act;
#pragma unroll
  for (int i = 0; i < nf; ++i) {
    const float shat = srow[i] / tsafe;
    o->gz[1 + i] = -mu * shat * scales[i];
    o->cs[1 + i] = shat * scales[i];
    const float r2 = tb.con_scales2[ci][i];
    o->g[1 + i] = d_act * r2 * jar[1 + i] + wz * o->gz[1 + i];
    o->hd[1 + i] = d_act * r2 + o->w_cone * r2;
  }
}

// Section timing (LR_PROFILE=1, off in normal builds): candidate 0 adds the
// clock64() cycles it spends in each section of the step to lane_prof, read
// back with lane_profile(). The card's machine may have no profiler that
// can attach, and one thread's latency is what sets this kernel's time.
// Sections: 0 fk, 1 com, 2 inertia, 3 cdof, 4 mass matrix, 5 velocities +
// RNE, 6 passive + actuation, 7 residual + outputs, 8 constraint rows,
// 9 unconstrained solve + Newton bookkeeping, 10 limit/pyramid rows,
// 11 elliptic blocks, 12 Newton Cholesky, 13 line search, 14 constraint
// force, 15 Euler; 19 prologue.
#define PROFILE_SLOTS 20
#if PROFILE
__device__ unsigned long long lane_prof[PROFILE_SLOTS];
#define TICK(n)                                                          \
  do {                                                                   \
    if (k == 0) {                                                        \
      const long long now_ = clock64();                                  \
      atomicAdd(&lane_prof[prof_slot], (unsigned long long)(now_ - prof_t)); \
      prof_slot = (n);                                                   \
      prof_t = now_;                                                     \
    }                                                                    \
  } while (0)
extern "C" int lane_profile(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lane_prof, sizeof(lane_prof));
}
#else
#define TICK(n)
#endif

extern "C" __global__ void __launch_bounds__(BLOCK)
lane_rollout_kernel(const float* __restrict__ qpos0,
                    const float* __restrict__ qvel0,
                    const float* __restrict__ values,
                    const float* __restrict__ aux_in,
                    const float* __restrict__ table,
                    float* __restrict__ out0, float* __restrict__ out1,
                    int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const TaskConst& tc = task_tb;
  const float h = tb.timestep[0];
#if PROFILE
  int prof_slot = PROFILE_SLOTS - 1;
  long long prof_t = clock64();
#endif

  float qpos[D1(NQ)], qvel[D1(NV)], ctrl[D1(NU)];
  float aux[D1(NAUXK)];
  float res[D1(NR)];
  float sums[D1(NTERM)];
  for (int i = 0; i < NQ; ++i) qpos[i] = qpos0[i * K + k];
  for (int i = 0; i < NV; ++i) qvel[i] = qvel0[i * K + k];
  if (NR > 0) {
    for (int i = 0; i < NAUXK; ++i) aux[i] = aux_in[i * K + k];
  }
  for (int i = 0; i < NTERM; ++i) sums[i] = 0.0f;
#if CTRL
  const float fb_alpha = values[k], fb_scale = values[K + k];
#endif

#pragma unroll 1
  for (int t = 0; t < H; ++t) {
#if CTRL
    {
      // feedback law on the tangent difference to the nominal state
      const float* row = table + (size_t)t * STRIDE;
      const float* xn = row + 2 * NU + NU * NDX;
      float dx[D1(NDX)];
      for (int j = 0; j < NJNT; ++j) {
        int qa = tb.jnt_qposadr[j], da = tb.jnt_dofadr[j];
        if (tb.jnt_type[j] == JNT_FREE) {
          for (int a = 0; a < 3; ++a) dx[da + a] = qpos[qa + a] - __ldg(xn + qa + a);
          const float qn[4] = {__ldg(xn + qa + 3), __ldg(xn + qa + 4),
                               __ldg(xn + qa + 5), __ldg(xn + qa + 6)};
          quat_sub_tangent(qpos + qa + 3, qn, dx + da + 3);
        } else {
          dx[da] = qpos[qa] - __ldg(xn + qa);
        }
      }
      for (int i = 0; i < NV; ++i) dx[NV + i] = qvel[i] - __ldg(xn + NQ + i);
      for (int u = 0; u < NU; ++u) {
        const float cff = __ldg(row + u) + fb_alpha * __ldg(row + NU + u);
        const float* g = row + 2 * NU + u * NDX;
        float acc = __ldg(g) * dx[0];
        for (int i = 1; i < NDX; ++i) acc += __ldg(g + i) * dx[i];
        ctrl[u] = clampf(cff + fb_scale * acc, tb.act_ctrlrange[u][0],
                         tb.act_ctrlrange[u][1]);
      }
    }
#else
    {
      int node = (t * P) / ((H - 1) > 1 ? (H - 1) : 1);
      node = node < P - 1 ? node : P - 1;
      for (int u = 0; u < NU; ++u) ctrl[u] = values[(node * NU + u) * K + k];
    }
#endif
    TICK(0);
    // ---- forward kinematics ----
    float xpos[NBODY][3], xquat[NBODY][4];
    float xanchor[D1(NJNT)][3], xaxis[D1(NJNT)][3];
    xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
    xquat[0][0] = 1.0f;
    xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
#pragma unroll 1
    for (int i = 1; i < NBODY; ++i) {
      const int pid = tb.body_parentid[i];
      float pos[3], quat[4], tmp[3];
      quat_rot(xquat[pid], tb.body_pos[i], tmp);
      for (int a = 0; a < 3; ++a) pos[a] = xpos[pid][a] + tmp[a];
      quat_mul(xquat[pid], tb.body_quat[i], quat);
      const int ja = tb.body_jntadr[i];
      const int jn = tb.body_jntnum[i];
      for (int jj = 0; jj < jn; ++jj) {
        const int j = ja + jj;
        const int qadr = tb.jnt_qposadr[j];
        const int jtype = tb.jnt_type[j];
        float anchor[3], axis[3];
        quat_rot(quat, tb.jnt_pos[j], anchor);
        for (int a = 0; a < 3; ++a) anchor[a] += pos[a];
        quat_rot(quat, tb.jnt_axis[j], axis);
        if (jtype == JNT_FREE) {
          for (int a = 0; a < 3; ++a) pos[a] = qpos[qadr + a];
          const float qn = sqrtf(qpos[qadr + 3] * qpos[qadr + 3] +
                                 qpos[qadr + 4] * qpos[qadr + 4] +
                                 qpos[qadr + 5] * qpos[qadr + 5] +
                                 qpos[qadr + 6] * qpos[qadr + 6]);
          const float inv = 1.0f / fmaxf(qn, 1e-12f);
          for (int a = 0; a < 4; ++a) quat[a] = qpos[qadr + 3 + a] * inv;
          for (int a = 0; a < 3; ++a) {
            anchor[a] = pos[a];
            axis[a] = tb.jnt_axis[j][a];  // global, not rotated
          }
        } else if (jtype == JNT_SLIDE) {
          const float disp = qpos[qadr] - tb.qpos0[qadr];
          for (int a = 0; a < 3; ++a) pos[a] += axis[a] * disp;
        } else {  // hinge
          const float half = 0.5f * (qpos[qadr] - tb.qpos0[qadr]);
          const float s = sinf(half);
          const float qloc[4] = {cosf(half), tb.jnt_axis[j][0] * s,
                                 tb.jnt_axis[j][1] * s,
                                 tb.jnt_axis[j][2] * s};
          quat_mul(quat, qloc, quat);
          quat_rot(quat, tb.jnt_pos[j], tmp);
          for (int a = 0; a < 3; ++a) pos[a] = anchor[a] - tmp[a];
        }
        for (int a = 0; a < 3; ++a) {
          xanchor[j][a] = anchor[a];
          xaxis[j][a] = axis[a];
        }
      }
      for (int a = 0; a < 3; ++a) xpos[i][a] = pos[a];
      for (int a = 0; a < 4; ++a) xquat[i][a] = quat[a];
    }
    TICK(1);
    // ---- com quantities ----
    float xipos[NBODY][3], subtree_com[NBODY][3];
    for (int i = 0; i < NBODY; ++i) {
      quat_rot(xquat[i], tb.body_ipos[i], xipos[i]);
      for (int a = 0; a < 3; ++a) {
        xipos[i][a] += xpos[i][a];
        subtree_com[i][a] = xipos[i][a] * tb.body_mass[i];
      }
    }
    for (int i = NBODY - 1; i > 0; --i) {
      const int pid = tb.body_parentid[i];
      for (int a = 0; a < 3; ++a) subtree_com[pid][a] += subtree_com[i][a];
    }
    for (int i = 0; i < NBODY; ++i)
      for (int a = 0; a < 3; ++a)
        subtree_com[i][a] *= tb.body_invsubtreemass[i];
    TICK(2);
    // ---- spatial inertia about the root's subtree com ----
    float cinert[NBODY][10];
#pragma unroll 1
    for (int i = 1; i < NBODY; ++i) {
      float quat[4];
      quat_mul(xquat[i], tb.body_iquat[i], quat);
      float I[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = 0; kk < 3; ++kk) {
        float e[3] = {0.0f, 0.0f, 0.0f};
        e[kk] = 1.0f;
        float ek[3];
        quat_rot(quat, e, ek);
        const float dk = tb.body_inertia[i][kk];
        I[0] += dk * ek[0] * ek[0];
        I[1] += dk * ek[0] * ek[1];
        I[2] += dk * ek[0] * ek[2];
        I[3] += dk * ek[1] * ek[1];
        I[4] += dk * ek[1] * ek[2];
        I[5] += dk * ek[2] * ek[2];
      }
      const float mass = tb.body_mass[i];
      const float* rf = subtree_com[tb.body_rootid[i]];
      const float d[3] = {xipos[i][0] - rf[0], xipos[i][1] - rf[1],
                          xipos[i][2] - rf[2]};
      const float d2 = dot3(d, d);
      cinert[i][0] = I[0] + mass * d2 - mass * d[0] * d[0];
      cinert[i][1] = I[1] - mass * d[0] * d[1];
      cinert[i][2] = I[2] - mass * d[0] * d[2];
      cinert[i][3] = I[3] + mass * d2 - mass * d[1] * d[1];
      cinert[i][4] = I[4] - mass * d[1] * d[2];
      cinert[i][5] = I[5] + mass * d2 - mass * d[2] * d[2];
      cinert[i][6] = d[0] * mass;
      cinert[i][7] = d[1] * mass;
      cinert[i][8] = d[2] * mass;
      cinert[i][9] = mass;
    }
    TICK(3);
    // ---- motion subspace per dof (angular 0..2, linear 3..5) ----
    float cdof[D1(NV)][6];
    for (int j = 0; j < NJNT; ++j) {
      const int bid = tb.jnt_bodyid[j];
      const int jtype = tb.jnt_type[j];
      const int da = tb.jnt_dofadr[j];
      const float* rf = subtree_com[tb.body_rootid[bid]];
      const float offset[3] = {rf[0] - xanchor[j][0], rf[1] - xanchor[j][1],
                               rf[2] - xanchor[j][2]};
      if (jtype == JNT_SLIDE) {
        for (int a = 0; a < 3; ++a) {
          cdof[da][a] = 0.0f;
          cdof[da][3 + a] = xaxis[j][a];
        }
      } else if (jtype == JNT_HINGE) {
        for (int a = 0; a < 3; ++a) cdof[da][a] = xaxis[j][a];
        cross3(xaxis[j], offset, &cdof[da][3]);
      } else {  // free: world translations, then body-frame rotation axes
        for (int kk = 0; kk < 3; ++kk) {
          for (int a = 0; a < 6; ++a) cdof[da + kk][a] = 0.0f;
          cdof[da + kk][3 + kk] = 1.0f;
          float e[3] = {0.0f, 0.0f, 0.0f};
          e[kk] = 1.0f;
          quat_rot(xquat[bid], e, &cdof[da + 3 + kk][0]);
          cross3(&cdof[da + 3 + kk][0], offset, &cdof[da + 3 + kk][3]);
        }
      }
    }
    TICK(4);
    // ---- composite inertias and the mass matrix ----
    float M[D1(NV)][D1(NV)];
    {
      float crb[NBODY][10];
      for (int i = 1; i < NBODY; ++i)
        for (int a = 0; a < 10; ++a) crb[i][a] = cinert[i][a];
      for (int i = NBODY - 1; i > 0; --i) {
        const int pid = tb.body_parentid[i];
        if (pid > 0)
          for (int a = 0; a < 10; ++a) crb[pid][a] += crb[i][a];
      }
#pragma unroll 1
      for (int i = 0; i < NV; ++i) {
        float f[6];
        inertia_mul(crb[tb.dof_bodyid[i]], cdof[i], f);
        for (int j = 0; j < NV; ++j)
          if (j > i) M[i][j] = 0.0f;
        for (int j = 0; j <= i; ++j) {
          float val = 0.0f;
          if (tb.dof_anc[i][j])
            val = dot3(f, cdof[j]) + dot3(f + 3, cdof[j] + 3);
          M[i][j] = val;
          M[j][i] = val;
        }
        M[i][i] += tb.dof_armature[i];
      }
    }
    TICK(5);
    // ---- body velocities, cdof_dot, RNE bias ----
    float cvel[NBODY][6];
    float cdof_dot[D1(NV)][6];
    for (int a = 0; a < 6; ++a) cvel[0][a] = 0.0f;
#pragma unroll 1
    for (int i = 1; i < NBODY; ++i) {
      const int pid = tb.body_parentid[i];
      float v[6];
      for (int a = 0; a < 6; ++a) v[a] = cvel[pid][a];
      const int da = tb.body_dofadr[i];
      const int nd = tb.body_dofnum[i];
      int kk = 0;
      while (kk < nd) {
        const int n = da + kk;
        if (tb.jnt_type[tb.dof_jntid[n]] == JNT_FREE) {
          for (int d = 0; d < 3; ++d) {   // translations: cdof_dot = 0
            for (int a = 0; a < 6; ++a) {
              cdof_dot[da + d][a] = 0.0f;
              v[a] += cdof[da + d][a] * qvel[da + d];
            }
          }
          float vpre[6];
          for (int a = 0; a < 6; ++a) vpre[a] = v[a];
          for (int d = 3; d < 6; ++d) {   // rotations: pre-velocity =
            motion_cross(vpre, cdof[da + d], cdof_dot[da + d]);  // translations
            for (int a = 0; a < 6; ++a) v[a] += cdof[da + d][a] * qvel[da + d];
          }
          kk += 6;
        } else {
          motion_cross(v, cdof[n], cdof_dot[n]);
          for (int a = 0; a < 6; ++a) v[a] += cdof[n][a] * qvel[n];
          kk += 1;
        }
      }
      for (int a = 0; a < 6; ++a) cvel[i][a] = v[a];
    }

    float rhs[D1(NV)];
    {
      float cacc[NBODY][6], cfrc[NBODY][6];
      for (int a = 0; a < 3; ++a) {
        cacc[0][a] = 0.0f;
        cacc[0][3 + a] = -tb.gravity[a];
      }
      for (int a = 0; a < 6; ++a) cfrc[0][a] = 0.0f;
#pragma unroll 1
      for (int i = 1; i < NBODY; ++i) {
        const int pid = tb.body_parentid[i];
        const int da = tb.body_dofadr[i];
        const int nd = tb.body_dofnum[i];
        for (int a = 0; a < 6; ++a) cacc[i][a] = cacc[pid][a];
        for (int d = 0; d < nd; ++d)
          for (int a = 0; a < 6; ++a)
            cacc[i][a] += cdof_dot[da + d][a] * qvel[da + d];
        float iv[6], ia[6], t0[3], t1[3];
        inertia_mul(cinert[i], cvel[i], iv);
        inertia_mul(cinert[i], cacc[i], ia);
        // force cross: (w x t + v x f, w x f)
        cross3(cvel[i], iv, t0);
        cross3(cvel[i] + 3, iv + 3, t1);
        for (int a = 0; a < 3; ++a) cfrc[i][a] = ia[a] + (t0[a] + t1[a]);
        cross3(cvel[i], iv + 3, t0);
        for (int a = 0; a < 3; ++a) cfrc[i][3 + a] = ia[3 + a] + t0[a];
      }
      for (int i = NBODY - 1; i > 0; --i) {
        const int pid = tb.body_parentid[i];
        if (pid > 0)
          for (int a = 0; a < 6; ++a) cfrc[pid][a] += cfrc[i][a];
      }
      // rhs = passive + actuation - bias; start with -bias
      for (int i = 0; i < NV; ++i) {
        const float* fb = cfrc[tb.dof_bodyid[i]];
        rhs[i] = dot3(cdof[i], fb) + dot3(cdof[i] + 3, fb + 3);
      }
    }
    TICK(6);
    // ---- passive + actuation ----
    float act_force[D1(NU)];
    {
      float qfrc[D1(NV)];
      for (int i = 0; i < NV; ++i) qfrc[i] = 0.0f;
      for (int j = 0; j < NJNT; ++j) {
        const int qadr = tb.jnt_qposadr[j], dadr = tb.jnt_dofadr[j];
        qfrc[dadr] -= tb.jnt_stiffness[j] * (qpos[qadr] - tb.qpos_spring[qadr]);
      }
      for (int i = 0; i < NV; ++i) qfrc[i] -= tb.dof_damping[i] * qvel[i];
#if FLUID
      // inertia-box fluid model: viscous and quadratic drag in each body's
      // inertial frame, applied at its com (coefficients from the host)
#pragma unroll 1
      for (int i = 1; i < NBODY; ++i) {
        if (!tb.fluid_on[i]) continue;
        const float* rf = subtree_com[tb.body_rootid[i]];
        const float off[3] = {xipos[i][0] - rf[0], xipos[i][1] - rf[1],
                              xipos[i][2] - rf[2]};
        float v_w[3], qw[4], la[3], ll[3], tq[3], fr[3], f_w[3], t_ref[3];
        cross3(cvel[i], off, v_w);
        for (int a = 0; a < 3; ++a)
          v_w[a] = (cvel[i][3 + a] + v_w[a]) - tb.wind[a];
        quat_mul(xquat[i], tb.body_iquat[i], qw);
        const float qc[4] = {qw[0], -qw[1], -qw[2], -qw[3]};
        quat_rot(qc, cvel[i], la);
        quat_rot(qc, v_w, ll);
        for (int a = 0; a < 3; ++a) {
          tq[a] = -tb.fluid_visc[i][0] * la[a] -
                  tb.fluid_dens_t[i][a] * fabsf(la[a]) * la[a];
          fr[a] = -tb.fluid_visc[i][1] * ll[a] -
                  tb.fluid_dens_f[i][a] * fabsf(ll[a]) * ll[a];
        }
        quat_rot(qw, fr, f_w);
        quat_rot(qw, tq, t_ref);
        float oxf[3];
        cross3(off, f_w, oxf);
        for (int a = 0; a < 3; ++a) t_ref[a] += oxf[a];
        for (int d = 0; d < NV; ++d)
          if (tb.body_dofmask[i][d])
            qfrc[d] += dot3(cdof[d], t_ref) + dot3(cdof[d] + 3, f_w);
      }
#endif
      for (int u = 0; u < NU; ++u) {
        float uin = ctrl[u];
        if (tb.act_ctrllimited[u])
          uin = clampf(uin, tb.act_ctrlrange[u][0], tb.act_ctrlrange[u][1]);
        const int dadr = tb.act_dadr[u];
        const float gear = tb.act_gear[u];
        const float length = qpos[tb.act_qadr[u]] * gear;
        const float velocity = qvel[dadr] * gear;
        float gain = tb.act_gainprm[u][0];
        if (!tb.act_gainfixed[u])
          gain = tb.act_gainprm[u][0] + tb.act_gainprm[u][1] * length +
                 tb.act_gainprm[u][2] * velocity;
        float force = gain * uin;
        if (tb.act_hasbias[u])
          force = force + tb.act_biasprm[u][0] +
                  tb.act_biasprm[u][1] * length +
                  tb.act_biasprm[u][2] * velocity;
        if (tb.act_forcelimited[u])
          force = clampf(force, tb.act_forcerange[u][0],
                         tb.act_forcerange[u][1]);
        act_force[u] = force;
        qfrc[dadr] += gear * force;
      }
      for (int i = 0; i < NV; ++i) rhs[i] = qfrc[i] - rhs[i];
    }
    TICK(7);
    // ---- task residual on the pre-step state; outputs of this step ----
    if (NR > 0) {
      StepCtx ctx;
      ctx.qpos = qpos; ctx.qvel = qvel; ctx.ctrl = ctrl;
      ctx.xpos = xpos; ctx.xquat = xquat; ctx.xipos = xipos;
      ctx.subtree_com = subtree_com; ctx.cvel = cvel;
      ctx.act_force = act_force; ctx.aux = aux; ctx.t = t;
      task_residual(ctx, tc, res);
    }
    if (MODE == 0) {
      float* o = out0 + (size_t)t * (NQ + NV + NR) * K + k;
      for (int i = 0; i < NQ; ++i) o[(size_t)i * K] = qpos[i];
      for (int i = 0; i < NV; ++i) o[(size_t)(NQ + i) * K] = qvel[i];
      for (int i = 0; i < NR; ++i) o[(size_t)(NQ + NV + i) * K] = res[i];
    } else if (MODE == 1) {
      float* o = out0 + (size_t)t * NR * K + k;
      for (int i = 0; i < NR; ++i) o[(size_t)i * K] = res[i];
    } else {
      int off = 0;
      for (int n = 0; n < NTERM; ++n) {
        sums[n] += term_cost(res + off, tb.term_dim[n], tb.term_type[n],
                             aux[NAUX + 2 * n], aux[NAUX + 2 * n + 1]);
        off += tb.term_dim[n];
      }
    }

#if HAS_ROWS
    TICK(8);
    // ---- constraint rows ----
    // joint limits: row r = 2*l + s touches dof lim_dadr[l] with sign +-1
    float lim_aref[D1(NLIM)], lim_d[D1(NLIM)];
    for (int l = 0; l < NLIMJ; ++l) {
      const int qadr = tb.lim_qadr[l], dadr = tb.lim_dadr[l];
      kbi(qpos[qadr] - tb.lim_lo[l] - tb.lim_margin[l], qvel[dadr],
          tb.lim_imp[l], tb.lim_invw[l], &lim_aref[2 * l], &lim_d[2 * l]);
      kbi(tb.lim_hi[l] - qpos[qadr] - tb.lim_margin[l], -qvel[dadr],
          tb.lim_imp[l], tb.lim_invw[l], &lim_aref[2 * l + 1],
          &lim_d[2 * l + 1]);
    }
    // plane-sphere contacts: direction Jacobians over the supporting dofs
    // (normal, tangent 1, tangent 2, then rotations about the same dirs)
    float prow_j[D1(NPROW)][D1(NSUP)], prow_aref[D1(NPROW)], prow_d[D1(NPROW)];
    float e_j[D1(NECON)][EROWS][D1(NSUP)], e_aref[D1(NECON)][EROWS];
    float e_dn[D1(NECON)];
    {
      int ip = 0, ie = 0;
#pragma unroll 1
      for (int ci = 0; ci < NCON; ++ci) {
        const int bid = tb.con_body[ci];
        const int condim = tb.con_condim[ci];
        const int ns = tb.con_nsup[ci];
        const float* nrm = tb.con_dirs[ci][0];
        float gpos[3];
        quat_rot(xquat[bid], tb.con_geompos[ci], gpos);
        for (int a = 0; a < 3; ++a) gpos[a] += xpos[bid][a];
        const float r0 = tb.con_radius[ci];
        const float h_c = nrm[0] * (gpos[0] - tb.con_planepos[ci][0]) +
                          nrm[1] * (gpos[1] - tb.con_planepos[ci][1]) +
                          nrm[2] * (gpos[2] - tb.con_planepos[ci][2]);
        const float dist = h_c - r0;
        const float gap = dist - tb.con_incm[ci];
        const float* rf = subtree_com[tb.body_rootid[bid]];
        float rvec[3];
        for (int a = 0; a < 3; ++a)
          rvec[a] = gpos[a] - nrm[a] * (r0 + 0.5f * dist) - rf[a];
        float jd[6][D1(NSUP)], vd[6];
        for (int il = 0; il < ns; ++il) {
          const float* cd = cdof[tb.con_sup[ci][il]];
          float jp[3];
          cross3(cd, rvec, jp);
          for (int a = 0; a < 3; ++a) jp[a] += cd[3 + a];
          for (int d = 0; d < 3; ++d) {
            jd[d][il] = dot3(jp, tb.con_dirs[ci][d]);
            jd[3 + d][il] = dot3(cd, tb.con_dirs[ci][d]);
          }
        }
        {
          float pv[3];
          cross3(cvel[bid], rvec, pv);
          for (int a = 0; a < 3; ++a) pv[a] += cvel[bid][3 + a];
          for (int d = 0; d < 3; ++d) {
            vd[d] = dot3(pv, tb.con_dirs[ci][d]);
            vd[3 + d] = dot3(cvel[bid], tb.con_dirs[ci][d]);
          }
        }
        if (condim == 1) {
          for (int il = 0; il < ns; ++il) prow_j[ip][il] = jd[0][il];
          kbi(gap, vd[0], tb.con_imp[ci], tb.con_invw[ci], &prow_aref[ip],
              &prow_d[ip]);
          ++ip;
        } else if (CONE == 1) {
          const int nf = condim - 1;
          kbi(gap, vd[0], tb.con_imp[ci], tb.con_invw[ci], &e_aref[ie][0],
              &e_dn[ie]);
          // rows past nf and columns past ns stay zero: every block is
          // EROWS x NSUP, so the solver's loops over it have fixed bounds
          for (int il = 0; il < NSUP; ++il)
            e_j[ie][0][il] = il < ns ? jd[0][il] : 0.0f;
#pragma unroll
          for (int a = 0; a < EROWS - 1; ++a) {
            const bool on = a < nf;
            for (int il = 0; il < NSUP; ++il)
              e_j[ie][1 + a][il] = on && il < ns ? jd[1 + a][il] : 0.0f;
            e_aref[ie][1 + a] = on ? -tb.con_imp[ci][IMP_B] * vd[1 + a] : 0.0f;
          }
          ++ie;
        } else {
          const int nf = condim - 1;
          for (int a = 0; a < nf; ++a) {
            for (int s = 0; s < 2; ++s) {
              const float smu = tb.prow_smu[ip];
              for (int il = 0; il < ns; ++il)
                prow_j[ip][il] = jd[0][il] + smu * jd[1 + a][il];
              kbi(gap, vd[0] + smu * vd[1 + a], tb.con_imp[ci],
                  tb.con_iw[ci], &prow_aref[ip], &prow_d[ip]);
              ++ip;
            }
          }
        }
      }
    }
    TICK(9);
    // ---- Newton on the acceleration ----
    float acc[D1(NV)], acc0[D1(NV)];
    float Hm[D1(NV)][D1(NV)];
    for (int i = 0; i < NV; ++i)
      for (int j = 0; j <= i; ++j) Hm[i][j] = M[i][j];
    chol_solve<D1(NV)>(Hm, rhs, acc0);
    for (int i = 0; i < NV; ++i) acc[i] = acc0[i];

#pragma unroll 1
    for (int it = 0; it < N_NEWTON; ++it) {
      float ma[D1(NV)], grad[D1(NV)], pstep[D1(NV)];
      float lim_jar[D1(NLIM)], prow_jar[D1(NPROW)], e_jar[D1(NECON)][EROWS];
      float e_g[D1(NECON)][EROWS];
      for (int i = 0; i < NV; ++i) {
        float s = 0.0f;
        for (int j = 0; j < NV; ++j) s += M[i][j] * (acc[j] - acc0[j]);
        ma[i] = s;
        grad[i] = 0.0f;
        for (int j = 0; j <= i; ++j) Hm[i][j] = M[i][j];
      }
    TICK(10);
#pragma unroll
      for (int r = 0; r < NLIM; ++r) {
        const int d = tb.lim_dadr[r >> 1];
        const float sg = (r & 1) ? -1.0f : 1.0f;
        const float jar = sg * acc[d] - lim_aref[r];
        lim_jar[r] = jar;
        const float act = jar < 0.0f ? lim_d[r] : 0.0f;
        grad[d] += sg * (act * jar);
        Hm[d][d] += act;
      }
      for (int r = 0; r < NPROW; ++r) {
        const int ci = tb.prow_con[r];
        const int ns = tb.con_nsup[ci];
        const int* sup = tb.con_sup[ci];
        float jar = 0.0f;
        for (int il = 0; il < ns; ++il) jar += prow_j[r][il] * acc[sup[il]];
        jar -= prow_aref[r];
        prow_jar[r] = jar;
        const float act = jar < 0.0f ? prow_d[r] : 0.0f;
        if (act != 0.0f) {
          for (int il = 0; il < ns; ++il) {
            grad[sup[il]] += prow_j[r][il] * (act * jar);
            for (int jl = il; jl < ns; ++jl)
              Hm[sup[jl]][sup[il]] += act * prow_j[r][il] * prow_j[r][jl];
          }
        }
      }
    TICK(11);
#pragma unroll 1   // rolled on purpose: four unrolled blocks outgrow the i-cache
      for (int e = 0; e < NECON; ++e) {
        const int ci = tb.econ_con[e];
        const int* sup = tb.con_sup[ci];
        // all loops over a block have fixed bounds (EROWS rows, NSUP columns,
        // zero-padded; a padded column's dof index is 0 and receives exact
        // zeros) and unroll, so loads issue together instead of one behind
        // each multiply
        float jar[EROWS];
#pragma unroll
        for (int r = 0; r < EROWS; ++r) jar[r] = 0.0f;
#pragma unroll
        for (int il = 0; il < NSUP; ++il) {
          const float a = acc[sup[il]];
#pragma unroll
          for (int r = 0; r < EROWS; ++r) jar[r] += e_j[e][r][il] * a;
        }
#pragma unroll
        for (int r = 0; r < EROWS; ++r) {
          jar[r] -= e_aref[e][r];
          e_jar[e][r] = jar[r];
        }
        EllTerms et;
        ell_terms(jar, e_dn[e], ci, &et);
#pragma unroll
        for (int r = 0; r < EROWS; ++r) e_g[e][r] = et.g[r];
        float v_l[D1(NSUP)], u_l[D1(NSUP)];
#pragma unroll
        for (int il = 0; il < NSUP; ++il) {
          float v = 0.0f, u = 0.0f, gi = 0.0f;
#pragma unroll
          for (int r = 0; r < EROWS; ++r) {
            const float jr = e_j[e][r][il];
            v += et.gz[r] * jr;
            u += et.cs[r] * jr;
            gi += jr * et.g[r];
          }
          v_l[il] = v;
          u_l[il] = u;
          grad[sup[il]] += gi;
        }
#pragma unroll
        for (int il = 0; il < NSUP; ++il) {
          float hj[EROWS];
#pragma unroll
          for (int r = 0; r < EROWS; ++r) hj[r] = et.hd[r] * e_j[e][r][il];
          const float wv = et.w_mid * v_l[il], wu = et.w_cone * u_l[il];
#pragma unroll
          for (int jl = il; jl < NSUP; ++jl) {
            float hij = 0.0f;
#pragma unroll
            for (int r = 0; r < EROWS; ++r) hij += hj[r] * e_j[e][r][jl];
            hij += wv * v_l[jl] - wu * u_l[jl];
            Hm[sup[jl]][sup[il]] += hij;
          }
        }
      }
    TICK(12);
      {
        float b[D1(NV)];
        for (int i = 0; i < NV; ++i) b[i] = ma[i] + grad[i];
        chol_solve<D1(NV)>(Hm, b, pstep);
        for (int i = 0; i < NV; ++i) pstep[i] = -pstep[i];
      }
      float tls = 1.0f;
    TICK(13);
      if (N_LS > 0) {
        // Safeguarded exact line search along pstep: phi is convex and
        // piecewise quadratic, so phi' is monotone. The bracket of its
        // root is built from the N_LS Newton evaluations themselves;
        // until an upper bracket exists growth is capped at 4x.
        float pmp = 0.0f, pma = 0.0f;
        for (int i = 0; i < NV; ++i) {
          float s = 0.0f;
          for (int j = 0; j < NV; ++j) s += M[i][j] * pstep[j];
          pmp += pstep[i] * s;
          pma += pstep[i] * ma[i];
        }
        float lim_jps[D1(NLIM)], prow_jps[D1(NPROW)], e_jps[D1(NECON)][EROWS];
        float dlo = pma;
#pragma unroll
        for (int r = 0; r < NLIM; ++r) {
          const float sg = (r & 1) ? -1.0f : 1.0f;
          lim_jps[r] = sg * pstep[tb.lim_dadr[r >> 1]];
          const float act = lim_jar[r] < 0.0f ? lim_d[r] : 0.0f;
          dlo += act * lim_jar[r] * lim_jps[r];
        }
        for (int r = 0; r < NPROW; ++r) {
          const int ci = tb.prow_con[r];
          const int ns = tb.con_nsup[ci];
          float s = 0.0f;
          for (int il = 0; il < ns; ++il)
            s += prow_j[r][il] * pstep[tb.con_sup[ci][il]];
          prow_jps[r] = s;
          const float act = prow_jar[r] < 0.0f ? prow_d[r] : 0.0f;
          dlo += act * prow_jar[r] * s;
        }
#pragma unroll 1
        for (int e = 0; e < NECON; ++e) {
          const int ci = tb.econ_con[e];
          float jps[EROWS];
#pragma unroll
          for (int r = 0; r < EROWS; ++r) jps[r] = 0.0f;
#pragma unroll
          for (int il = 0; il < NSUP; ++il) {
            const float ps = pstep[tb.con_sup[ci][il]];
#pragma unroll
            for (int r = 0; r < EROWS; ++r) jps[r] += e_j[e][r][il] * ps;
          }
#pragma unroll
          for (int r = 0; r < EROWS; ++r) {
            e_jps[e][r] = jps[r];
            dlo += e_g[e][r] * jps[r];
          }
        }
        const float kBig = 1e6f;
        float lo = 0.0f, hi = kBig, dhi = 0.0f;
#pragma unroll 1
        for (int ls = 0; ls < N_LS; ++ls) {
          float dphi = pma + tls * pmp;
          float ddphi = pmp;
#pragma unroll
          for (int r = 0; r < NLIM; ++r) {
            const float jart = lim_jar[r] + tls * lim_jps[r];
            const float act = jart < 0.0f ? lim_d[r] : 0.0f;
            dphi += act * jart * lim_jps[r];
            ddphi += act * lim_jps[r] * lim_jps[r];
          }
          for (int r = 0; r < NPROW; ++r) {
            const float jart = prow_jar[r] + tls * prow_jps[r];
            const float act = jart < 0.0f ? prow_d[r] : 0.0f;
            dphi += act * jart * prow_jps[r];
            ddphi += act * prow_jps[r] * prow_jps[r];
          }
#pragma unroll 1
          for (int e = 0; e < NECON; ++e) {
            const int ci = tb.econ_con[e];
            float jart[EROWS];
#pragma unroll
            for (int r = 0; r < EROWS; ++r)
              jart[r] = e_jar[e][r] + tls * e_jps[e][r];
            EllTerms et;
            ell_terms(jart, e_dn[e], ci, &et);
            float vp = 0.0f, up = 0.0f, hs = 0.0f;
#pragma unroll
            for (int r = 0; r < EROWS; ++r) {
              dphi += et.g[r] * e_jps[e][r];
              vp += et.gz[r] * e_jps[e][r];
              up += et.cs[r] * e_jps[e][r];
              hs += et.hd[r] * e_jps[e][r] * e_jps[e][r];
            }
            ddphi += hs + et.w_mid * vp * vp - et.w_cone * up * up;
          }
          const bool neg = dphi < 0.0f;
          if (neg) { lo = tls; dlo = dphi; } else { hi = tls; dhi = dphi; }
          const float t_n = tls - dphi / fmaxf(ddphi, 1e-12f);
          // fallback when Newton leaves the bracket: regula falsi on a
          // real bracket; geometric growth while unbracketed above
          const float denom = dhi - dlo;
          float t_s = lo - dlo * (hi - lo) /
                               (fabsf(denom) < 1e-12f ? 1.0f : denom);
          t_s = clampf(t_s, lo, hi);
          const bool inb = (t_n > lo) && (t_n < hi);
          if (hi >= kBig) {
            const float cap = 4.0f * fmaxf(tls, 1.0f);
            tls = fminf(fmaxf(inb ? t_n : tls, lo), cap);
          } else {
            tls = inb ? t_n : t_s;
          }
        }
        tls = fminf(fmaxf(tls, 0.0f), hi);
      }
      for (int i = 0; i < NV; ++i) acc[i] += tls * pstep[i];
    }
    TICK(14);
    // constraint force back into the right-hand side
    for (int r = 0; r < NLIM; ++r) {
      const int d = tb.lim_dadr[r >> 1];
      const float sg = (r & 1) ? -1.0f : 1.0f;
      const float jar = sg * acc[d] - lim_aref[r];
      const float act = jar < 0.0f ? lim_d[r] : 0.0f;
      rhs[d] -= sg * (act * jar);
    }
    for (int r = 0; r < NPROW; ++r) {
      const int ci = tb.prow_con[r];
      const int ns = tb.con_nsup[ci];
      const int* sup = tb.con_sup[ci];
      float jar = 0.0f;
      for (int il = 0; il < ns; ++il) jar += prow_j[r][il] * acc[sup[il]];
      jar -= prow_aref[r];
      const float act = jar < 0.0f ? prow_d[r] : 0.0f;
      for (int il = 0; il < ns; ++il)
        rhs[sup[il]] -= prow_j[r][il] * (act * jar);
    }
#pragma unroll 1
    for (int e = 0; e < NECON; ++e) {
      const int ci = tb.econ_con[e];
      const int* sup = tb.con_sup[ci];
      float jar[EROWS];
#pragma unroll
      for (int r = 0; r < EROWS; ++r) jar[r] = 0.0f;
#pragma unroll
      for (int il = 0; il < NSUP; ++il) {
        const float a = acc[sup[il]];
#pragma unroll
        for (int r = 0; r < EROWS; ++r) jar[r] += e_j[e][r][il] * a;
      }
#pragma unroll
      for (int r = 0; r < EROWS; ++r) jar[r] -= e_aref[e][r];
      EllTerms et;
      ell_terms(jar, e_dn[e], ci, &et);
#pragma unroll
      for (int il = 0; il < NSUP; ++il) {
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < EROWS; ++r) s += e_j[e][r][il] * et.g[r];
        rhs[sup[il]] -= s;
      }
    }
#endif  // HAS_ROWS
    TICK(15);
    // ---- implicit-damping Euler ----
    {
      float qacc[D1(NV)];
      for (int i = 0; i < NV; ++i) M[i][i] += tb.dof_hdamping[i];
      chol_solve<D1(NV)>(M, rhs, qacc);
      for (int i = 0; i < NV; ++i) qvel[i] += h * qacc[i];
    }
    for (int j = 0; j < NJNT; ++j) {
      const int qadr = tb.jnt_qposadr[j], dadr = tb.jnt_dofadr[j];
      if (tb.jnt_type[j] == JNT_FREE) {
        for (int a = 0; a < 3; ++a) qpos[qadr + a] += h * qvel[dadr + a];
        const float* w = qvel + dadr + 3;
        const float angle = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
        const float safe = fmaxf(angle, 1e-12f);
        const float half = 0.5f * angle * h;
        const float sh = sinf(half), ch = cosf(half);
        const float dq[4] = {ch, w[0] / safe * sh, w[1] / safe * sh,
                             w[2] / safe * sh};
        float qn[4];
        quat_mul(qpos + qadr + 3, dq, qn);
        const float norm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] +
                                 qn[2] * qn[2] + qn[3] * qn[3]);
        const float inv = 1.0f / fmaxf(norm, 1e-12f);
        for (int a = 0; a < 4; ++a) qpos[qadr + 3 + a] = qn[a] * inv;
      } else {
        qpos[qadr] += h * qvel[dadr];
      }
    }
  }

  if (MODE == 2) {
    for (int n = 0; n < NTERM; ++n) out0[(size_t)n * K + k] = sums[n];
  }
  if (MODE != 0) {
    for (int i = 0; i < NQ; ++i) out1[(size_t)i * K + k] = qpos[i];
    for (int i = 0; i < NV; ++i) out1[(size_t)(NQ + i) * K + k] = qvel[i];
  }
}

extern "C" int lane_tables_size() {
  return (int)(sizeof(TablesHead) + sizeof(TaskConst));
}

// Stream-ordered upload of the constant tables from a host buffer that
// holds the generic tables followed by the task's constant block.
extern "C" int lane_set_tables(const void* src, int nbytes, void* stream) {
  if (nbytes != lane_tables_size()) return -1;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      tb, src, sizeof(TablesHead), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbolAsync(
      task_tb, (const char*)src + sizeof(TablesHead), sizeof(TaskConst), 0,
      cudaMemcpyHostToDevice, (cudaStream_t)stream);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lane_rollout(const float* qpos0, const float* qvel0,
                            const float* values, const float* aux,
                            const float* table, float* out0, float* out1,
                            int K, void* stream) {
  const int grid = (K + BLOCK - 1) / BLOCK;
  lane_rollout_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      qpos0, qvel0, values, aux, table, out0, out1, K);
  return (int)cudaGetLastError();
}
