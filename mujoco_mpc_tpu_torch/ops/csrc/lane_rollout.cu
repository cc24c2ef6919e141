// Lane rollout kernel: K candidate rollouts over the whole horizon in one
// launch, a team of LR_TEAM lanes per candidate.
//
// Replaces the TPU (Pallas) kernel mujoco_mpc_tpu/ops/step_lane.py:
// build_rollout_kernel. Per horizon step and candidate: forward kinematics,
// com quantities, composite-inertia mass matrix, RNE bias, passive forces,
// (springs, dampers, the inertia-box fluid model), joint- and
// site-transmission actuation, the task residual on the pre-step state,
// joint-limit rows and ground contacts (a point per sphere centre, capsule
// end or box corner against a world-static plane: pyramidal rows, condim-1
// rows or elliptic cone blocks), with LR_BODY=1 body-body contacts (a point
// per sphere / capsule segment pair, capsule end in a box or box corner in
// the other box, its frame built from the normal, both bodies' Jacobians),
// Newton on the acceleration with a safeguarded exact line search,
// implicit-damping Euler with quaternion integration.
//
// One generic source. A build specialises it with compile-time dimensions
// (-DLR_NQ=.. etc., listed below) and one task-residual header
// (-DRESIDUAL_HEADER=...). Everything else about the model — tree tables,
// body/joint/actuator constants, limit rows, per-contact frames and solver
// parameters, the task's constants — is data filled by the wrapper
// (ops/step_lane.py packs the same field order): the generic tables
// (`TablesHead`) and the per-point and per-row tables (`ContactTables`) in
// one global buffer, the task's constant block (`TaskConst task_tb`) in
// __constant__ memory, where only lane 0 reads it (one address a warp).
// Candidates are the last, contiguous axis of every array in global memory.
//
// Design for the H100 (bound: the latency of one long dependent program per
// candidate; a launch moves only a few megabytes):
//  * A team of TEAM lanes (a power of two <= 32, inside one warp) works on
//    one candidate; a block holds several teams (teams per block chosen at
//    launch). The lanes split every loop that has independent iterations:
//    per body (com, spatial inertias, RNE forces), per joint (motion
//    subspaces, integration), per mass-matrix entry, per contact (narrow
//    phase, Jacobians), per constraint row (Newton, line search, constraint
//    force), per Hessian entry, and the Cholesky factorisations
//    (lane_team.cuh team_chol_solve); the tree recursions (forward
//    kinematics, body velocities and accelerations, the subtree sums) go
//    level by level, lanes over a level's bodies. The actuators and the
//    task residual stay on lane 0.
//  * An exact active-row cull: once every contact's gap and every limit
//    row's position is known, only those < 0 (or NaN) enter the rows, in
//    their serial order (ballot + rank, lane_team.cuh team_compact). Why
//    that is exact: a row whose position is >= 0 gets dcoef = 0 from `kbi`
//    (as in the JAX package, mujoco_mpc_tpu/ops/step_lane.py:640), so its
//    act = 0 in every Newton and line-search evaluation and in the
//    constraint force; a culled elliptic block has e_dn = 0, for which
//    `ell_terms` returns g = hd = w_mid = w_cone = 0. A finite row of that
//    kind adds exact zeros (+-0.0) to the gradient, the Hessian, dphi,
//    ddphi and the constraint force, and adding a zero changes no float
//    (at most the sign of a zero sum, which no later comparison or product
//    tells apart). All the rows of a contact share its gap, so the cull
//    goes by contact. With no row left (an airborne step) the Newton solve
//    is skipped: its result, the acceleration, is read only by the rows.
//    Non-finite states: a NaN gap or position fails `>= 0` and stays in the
//    list, where its NaN poisons the step as before. A culled row has a
//    finite Jacobian and aref, so its jar is non-finite only when the
//    acceleration is, and then M (acc - acc0) and everything after it is
//    already non-finite: a non-finite state still comes out non-finite.
//    The list holds the worst case (every row active): its first
//    LR_ROWCAP rows and LR_BLKCAP elliptic blocks in shared memory, the rest
//    in a per-candidate global workspace (`ws`). No cap drops a row.
//  * The per-candidate working set (state, kinematics, cdof, cvel, M, the
//    Newton matrix and the compacted rows, `Work`) lives in dynamic shared
//    memory, one per team; nothing is indexed in thread-local memory.
//  * The tables are staged into shared memory at block start by Hopper's
//    bulk asynchronous copy (cp.async.bulk with an mbarrier): the generic
//    tables first, the contact tables behind them, waited for only before
//    the first contact pass, so that copy overlaps the first step's
//    kinematics. Where the contact tables do not fit beside two teams'
//    working sets they stay in global memory and are read through __ldg
//    (`lane_ctab_in_shared()` says which).
//  * Reductions (line-search sums, dot products) go through a fixed
//    __shfl_xor_sync tree and each Hessian entry is owned by one lane that
//    sums over the compacted rows in their serial order, so a launch is
//    deterministic; against a serial evaluation only the order of the
//    dot products moves.
//  * Tensor cores do not serve it: systems of 6-32 unknowns per candidate
//    with sparse, data-dependent supports, in float32 with TF32 off.
//
// Control (LR_CTRL): 0 = zero-order-hold spline nodes, one column of
// `values` (P*NU, K) per candidate; 1 = the feedback law of iLQG's line
// searches, u = clip(u_nom[t] + alpha k[t] + scale K[t] dx, ctrlrange), with
// alpha = values[0], scale = values[1] per candidate, dx the tangent
// difference to the nominal state, and `table` (H, STRIDE) the per-step
// blocks [u_nom, k, K row-major, x_nom] shared by all candidates, read
// through the read-only path.
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
    !defined(LR_NBCON) || \
    !defined(LR_BODY) || \
    !defined(LR_NPROW) || \
    !defined(LR_NECON) || \
    !defined(LR_NSUP) || \
    !defined(LR_NLVL) || \
    !defined(LR_H) || \
    !defined(LR_P) || \
    !defined(LR_NAUX) || \
    !defined(LR_NAUXS) || \
    !defined(LR_NTERM) || \
    !defined(LR_NR) || \
    !defined(LR_N_NEWTON) || \
    !defined(LR_N_LS) || \
    !defined(LR_MODE) || \
    !defined(LR_CONE) || \
    !defined(LR_TEAM) || \
    !defined(LR_ROWCAP) || \
    !defined(LR_BLKCAP) || \
    !defined(LR_EROWS) || \
    !defined(LR_PROFILE) || \
    !defined(LR_CTRL) || \
    !defined(LR_FLUID) || \
    !defined(LR_SITE) || \
    !defined(RESIDUAL_HEADER)
#error "lane_rollout.cu needs its compile-time dimensions (see ops/step_lane.py)"
#endif
#define NQ LR_NQ
#define NV LR_NV
#define NU LR_NU
#define NBODY LR_NBODY
#define NJNT LR_NJNT
#define NLIMJ LR_NLIMJ
#define NCON LR_NCON     // ground contact points
#define NBCON LR_NBCON   // body contact entries
#define BODY LR_BODY
#define NPROW LR_NPROW
#define NECON LR_NECON
#define NSUP LR_NSUP
#define NLVL LR_NLVL     // depth of the body tree
#define H LR_H
#define P LR_P
#define NAUX LR_NAUX
#define NAUXS LR_NAUXS
#define NTERM LR_NTERM
#define NR LR_NR
#define N_NEWTON LR_N_NEWTON
#define N_LS LR_N_LS
#define MODE LR_MODE
#define CONE LR_CONE
#define TEAM LR_TEAM
#define ROWCAP LR_ROWCAP   // scalar rows a team keeps in shared memory
#define BLKCAP LR_BLKCAP   // elliptic blocks a team keeps in shared memory
#define EROWS LR_EROWS
#define PROFILE LR_PROFILE
#define CTRL LR_CTRL
#define FLUID LR_FLUID
#define SITE LR_SITE

#define D1(n) ((n) > 0 ? (n) : 1)
#define NVP D1(NV)
#define NLIM (2 * (NLIMJ))
// aux rows a team keeps in shared memory: the task's static rows, then the
// norm parameters (global rows NAUX ..); per-step rows stay in global memory
#define NAUXK ((NAUXS) + 2 * (NTERM))
// contact index ci: the ground points, then the body entries
#define NCT ((NCON) + (NBCON))
#define HAS_ROWS ((NLIMJ) > 0 || NCT > 0)
// scalar rows of a step when every one is active: limit sides, then the
// pyramidal / condim-1 rows of the contacts
#define MAXROWS (NLIM + (NPROW))
#define NDX (2 * (NV))
#define STRIDE (2 * (NU) + (NU) * NDX + (NQ) + (NV))
// threads a block may have: 255 registers a thread stay allowed
#define MAXTHREADS 256
// dynamic shared memory a block may opt into on an H100
#define SMEM_MAX 232448

#define JNT_FREE 0
#define JNT_SLIDE 2
#define JNT_HINGE 3

#include "lane_math.cuh"
#include "lane_team.cuh"

// ---------------------------------------------------------------- tables --

// Per contact point (index ci: ground points, then body entries) and per
// row; field order and padded shapes mirror _pack_tables. All members are 4
// bytes wide, so the struct has no padding.
struct ContactTables {
  int con_body[D1(NCON)];          // ground points: the body
  int con_condim[D1(NCT)];
  int con_nsup[D1(NCT)];
  int con_sup[D1(NCT)][D1(NSUP)];  // supporting dofs (either body's), sorted
  int con_prow[D1(NCT)];           // a pyramidal contact's first row
  float con_geompos[D1(NCON)][3];  // ground points: body-local point
  float con_radius[D1(NCON)];
  float con_planepos[D1(NCON)][3];
  float con_dirs[D1(NCON)][3][3];  // normal, tangent 1, tangent 2
  float con_imp[D1(NCT)][9];
  float con_incm[D1(NCT)];
  float con_invw[D1(NCT)];         // clamped at 1e-12
  float con_iw[D1(NCT)];           // pyramidal diagonal, clamped at 1e-12
  float con_mu[D1(NCT)];           // elliptic mu_eff
  float con_1pmu2[D1(NCT)];        // 1 + mu_eff^2
  float con_scales[D1(NCT)][5];
  float con_scales2[D1(NCT)][5];
  float prow_smu[D1(NPROW)];       // sign * friction of the row's axis
#if BODY
  // body contact entries (ops/step_lane.py _body_plan): side a is a
  // segment (centre, axis, half-length, radius; a sphere's half-length is
  // 0) or a point of radius ra, side b a segment (BODY_SEG) or a box
  // (BODY_BOX: centre, geom quaternion, half-sizes), both body-local; the
  // normal points from body b1 (geom1's) to b2
  int bc_kind[NBCON];
  int bc_b1[NBCON];
  int bc_b2[NBCON];
  int bc_ba[NBCON];
  int bc_bb[NBCON];
  int bc_flip[NBCON];              // the point is geom2's: normal box -> point
  float bc_pa[NBCON][3];
  float bc_ra[NBCON];
  float bc_pb[NBCON][3];
  float bc_ua[NBCON][3];
  float bc_ub[NBCON][3];
  float bc_ha[NBCON];
  float bc_hb[NBCON];
  float bc_rb[NBCON];
  float bc_qb[NBCON][4];
  float bc_sb[NBCON][3];
#endif
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
  int term_type[D1(NTERM)];
  int term_dim[D1(NTERM)];
  int body_dofmask[NBODY][D1(NV)];  // dof moves the body
  int fluid_on[NBODY];              // body takes fluid forces
  // the tree by levels: bodies by depth (level d is lvl_body[lvl_start[d]
  // .. lvl_start[d + 1]), the world alone at 0), and the children of body
  // b, child_list[child_start[b] .. child_start[b + 1]), by descending
  // index: the order in which a serial loop over the bodies from the last
  // to the first adds them into b
  int lvl_body[NBODY];
  int lvl_start[NLVL + 2];
  int child_start[NBODY + 1];
  int child_list[D1(NBODY - 1)];
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
  float wind[3];
  float fluid_visc[NBODY][2];      // viscous torque, force coefficients
  float fluid_dens_f[NBODY][3];    // quadratic-drag force, per local axis
  float fluid_dens_t[NBODY][3];    // quadratic-drag torque, per local axis
  int act_site[D1(NU)];            // actuator has a site transmission
  int act_sitebody[D1(NU)];        // its site's body
  float act_sitepos[D1(NU)][3];    // site position, quaternion in the body
  float act_sitequat[D1(NU)][4];
  float act_gear6[D1(NU)][6];      // force (0..2), torque (3..5) in the site
};

// ------------------------------------------------ per-team working set --

// A set of dofs (a row's support) as bits, 32 a word.
#define MW ((NVP + 31) / 32)

__device__ __forceinline__ bool has_dof(const unsigned* m, int i) {
  if constexpr (MW == 1) {
    return (m[0] >> i) & 1u;
  } else {
    return (m[i >> 5] >> (i & 31)) & 1u;
  }
}

// Calls f(i) for the dofs of m in increasing order.
template <class F>
__device__ __forceinline__ void for_dofs(const unsigned* m, F f) {
  for (int w = 0; w < MW; ++w)
    for (unsigned b = m[w]; b; b &= b - 1u) f(32 * w + __ffs((int)b) - 1);
}

// One active scalar row: a limit side, a condim-1 row or a pyramidal row.
// Its Jacobian is indexed by dof and read only on its support `sup` (the
// dofs a contact's supporting bodies move), in increasing dof order: the
// order of a serial sum over the sorted support.
struct Row {
  float J[NVP];
  float aref, d, jar, jps;
  unsigned sup[MW];
};

// One active elliptic cone block (EROWS rows; a contact of lower condim
// has zero rows past its own).
struct Blk {
  float J[EROWS][NVP];
  unsigned sup[MW];
  float aref[EROWS], jar[EROWS], jps[EROWS], g[EROWS], hd[EROWS];
  float gz[EROWS], cs[EROWS];
  float v[NVP], u[NVP];
  float dn, w_mid, w_cone;
  int ci;
};

struct Work {
  float qpos[D1(NQ)], qvel[NVP], ctrl[D1(NU)];
  float aux[D1(NAUXK)], res[D1(NR)], sums[D1(NTERM)];
  float xpos[NBODY][3], xquat[NBODY][4];
  float xanchor[D1(NJNT)][3], xaxis[D1(NJNT)][3];
  float xipos[NBODY][3], subtree_com[NBODY][3];
  float cinert[NBODY][10], crb[NBODY][10];
  float cvel[NBODY][6], cacc[NBODY][6], cfrc[NBODY][6];
  float cdof[NVP][6], cdof_dot[NVP][6], fm[NVP][6];
  float M[NVP][NVP], Hm[NVP][NVP];
  float rhs[NVP], act_force[D1(NU)], dx[D1(NDX)];
  float acc[NVP], acc0[NVP], ma[NVP], pstep[NVP], vb[NVP], dinv[NVP];
  int lim_list[D1(NLIM)];
  int con_list[D1(NCT)];
  Row rows[D1(ROWCAP)];
  Blk blks[D1(BLKCAP)];
};

#define RND16(n) ((((n) + 15) / 16) * 16)
constexpr int kHead16 = RND16((int)sizeof(TablesHead));
constexpr int kCtab16 = RND16((int)sizeof(ContactTables));
constexpr int kWork16 = RND16((int)sizeof(Work));
// rows and blocks past the shared-memory caps, per candidate
constexpr int kOvfRows = MAXROWS > ROWCAP ? MAXROWS - ROWCAP : 0;
constexpr int kOvfBlks = NECON > BLKCAP ? NECON - BLKCAP : 0;
constexpr int kWsFloats =
    (kOvfRows * (int)sizeof(Row) + kOvfBlks * (int)sizeof(Blk) +
     (int)sizeof(float) - 1) / (int)sizeof(float);
// shared memory: two mbarriers, the generic tables, the contact tables
// (when they fit beside two teams), then one Work per team
constexpr bool kCtStaged =
    NCT > 0 && 16 + kHead16 + kCtab16 + 2 * kWork16 <= SMEM_MAX;
constexpr int kHeadOff = 16;
constexpr int kCtabOff = kHeadOff + kHead16;
constexpr int kWorkOff = kCtabOff + (kCtStaged ? kCtab16 : 0);

// The tables' home in global memory (uploaded by lane_set_tables): the
// generic tables, then the contact tables at kHead16.
__device__ __align__(16) unsigned char lr_tables[kHead16 + kCtab16];

DYNAMIC_SMEM(lr_smem);

// The generic tables, in shared memory (residual headers read them too).
#define tb (*reinterpret_cast<const TablesHead*>(lr_smem + kHeadOff))
// The contact tables, in shared memory or global memory (kCtStaged); read
// every field through ctl() so that the global form goes through __ldg.
#define CT (*reinterpret_cast<const ContactTables*>(        \
    kCtStaged ? lr_smem + kCtabOff : lr_tables + kHead16))
template <class T>
__device__ __forceinline__ T ctl(const T& x) {
  if constexpr (kCtStaged) {
    return x;
  } else {
    return __ldg(&x);
  }
}
template <int N>
__device__ __forceinline__ void ctl_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = ctl(p[i]);
}

// f(b) for the bodies of level d, spread over the lanes.
template <class F>
__device__ __forceinline__ void for_level(const Team& tm, int d, F f) {
  for (int q = tb.lvl_start[d] + tm.lane; q < tb.lvl_start[d + 1]; q += TEAM)
    f(tb.lvl_body[q]);
}

// Sums a per-body quantity (n floats a body) up the tree, as the serial
// loop `for b = NBODY-1 .. 1: v[parent(b)] += v[b]` does: level by level
// from the deepest, each parent (the world too, if `world`) adding its
// children in descending index order, lanes over the parents of a level.
template <int N>
__device__ __forceinline__ void team_tree_sum(const Team& tm, float (*v)[N],
                                              bool world) {
  for (int d = NLVL - 1; d >= (world ? 0 : 1); --d) {
    for_level(tm, d, [&](int p) {
      for (int q = tb.child_start[p]; q < tb.child_start[p + 1]; ++q) {
        const int c = tb.child_list[q];
#pragma unroll
        for (int a = 0; a < N; ++a) v[p][a] += v[c][a];
      }
    });
    team_sync(tm);
  }
}

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
  const float* aux;        // the task's NAUXS static aux rows
  const float* aux_rows;   // every aux row, (NAUX + 2 NTERM, K), global
  int K, k;
  int t;
  // row i of the aux tensor for this candidate (per-step rows), read from
  // global memory through the read-only path
  __device__ __forceinline__ float aux_at(int i) const {
    return __ldg(aux_rows + (size_t)i * K + k);
  }
};

// impedance constant block: d0 dmax width mid power a_c b_c b_coef k_coef
#define IMP_B 7
#define IMP_K 8

// The task's constant block: the residual header defines TaskConst and
// reads the generic tables through `tb`.
#define LR_STR2(x) #x
#define LR_STR(x) LR_STR2(x)
#include LR_STR(RESIDUAL_HEADER)

__constant__ TaskConst task_tb;

// ------------------------------------------------------- row arithmetic --

__device__ __forceinline__ float impedance(float pos, const float* ic) {
  const float x = clampf(fabsf(pos) / ic[2], 0.0f, 1.0f);
  // power 2 (the default) as a product, as the array libraries do
  const float y = ic[4] == 2.0f
      ? (x <= ic[3] ? ic[5] * (x * x) : 1.0f - ic[6] * ((1.0f - x) * (1.0f - x)))
      : (x <= ic[3] ? ic[5] * powf(x, ic[4])
                    : 1.0f - ic[6] * powf(1.0f - x, ic[4]));
  return clampf(ic[0] + y * (ic[1] - ic[0]), 1e-4f, 0.9999f);
}

// Reference acceleration and gated stiffness of a one-sided row: dcoef is
// zero unless pos < 0 (the cull rests on that).
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
// (diag + w_mid gz gz^T - w_cone cs cs^T). With dn = 0 (a block whose gap
// is >= 0) every output is zero: the cull rests on that.
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
  const float mu = ctl(CT.con_mu[ci]);
  float scales[D1(EROWS - 1)], scales2[D1(EROWS - 1)];
  ctl_vec<EROWS - 1>(CT.con_scales[ci], scales);
  ctl_vec<EROWS - 1>(CT.con_scales2[ci], scales2);
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
  const float w_coef = dn / ctl(CT.con_1pmu2[ci]);
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
    const float r2 = scales2[i];
    o->g[1 + i] = d_act * r2 * jar[1 + i] + wz * o->gz[1 + i];
    o->hd[1 + i] = d_act * r2 + o->w_cone * r2;
  }
}

// --------------------------------------------------------- contact geometry

#if BODY
#define BODY_SEG 0
#define BODY_BOX 1

// The norm's 1e-18 and the outside test's 1e-9 meet exactly at a point on
// the box (sqrt(0 + 1e-18) == 1e-9 in float32 and in float64): they are
// written as casts, not f-suffixed literals, so that a host build of this
// source in double precision keeps them in step with the plain version.
#define BODY_NORM_EPS ((float)1e-18)
#define BODY_OUTSIDE ((float)1e-9)

__device__ __forceinline__ float norm3_eps(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + BODY_NORM_EPS);
}

// Contact point, normal (from geom1 to geom2) and distance of body entry e:
// the closest points of two segments by three clamps (BODY_SEG), or a point
// of radius ra against a box, outside its closest point, inside its
// nearest face (BODY_BOX). Counterpart of step_lane.body_contact_point.
__device__ float body_contact(int e, const float (*xpos)[3],
                              const float (*xquat)[4], float* pt,
                              float* nrm) {
  const int ba = ctl(CT.bc_ba[e]), bb = ctl(CT.bc_bb[e]);
  const float ra = ctl(CT.bc_ra[e]);
  float pa_l[3], pb_l[3];
  ctl_vec<3>(CT.bc_pa[e], pa_l);
  ctl_vec<3>(CT.bc_pb[e], pb_l);
  float ca[3];
  quat_rot(xquat[ba], pa_l, ca);
  for (int a = 0; a < 3; ++a) ca[a] = xpos[ba][a] + ca[a];
  if (ctl(CT.bc_kind[e]) == BODY_SEG) {
    float ua_l[3], ub_l[3];
    ctl_vec<3>(CT.bc_ua[e], ua_l);
    ctl_vec<3>(CT.bc_ub[e], ub_l);
    float cb[3], ax1[3], ax2[3], r_[3], pa[3], d[3];
    quat_rot(xquat[bb], pb_l, cb);
    for (int a = 0; a < 3; ++a) cb[a] = xpos[bb][a] + cb[a];
    quat_rot(xquat[ba], ua_l, ax1);
    quat_rot(xquat[bb], ub_l, ax2);
    const float h1 = ctl(CT.bc_ha[e]), h2 = ctl(CT.bc_hb[e]);
    for (int a = 0; a < 3; ++a) r_[a] = cb[a] - ca[a];
    const float a_d = dot3(ax1, ax2);
    const float s1d = dot3(ax1, r_), s2d = dot3(ax2, r_);
    const float den = fmaxf(1.0f - a_d * a_d, 1e-9f);
    float t1 = clampf((s1d - a_d * s2d) / den, -h1, h1);
    const float t2 = clampf(a_d * t1 - s2d, -h2, h2);
    t1 = clampf(a_d * t2 + s1d, -h1, h1);
    for (int a = 0; a < 3; ++a) {
      pa[a] = ca[a] + ax1[a] * t1;
      d[a] = (cb[a] + ax2[a] * t2) - pa[a];
    }
    const float dn = norm3_eps(d);
    for (int a = 0; a < 3; ++a) nrm[a] = d[a] / dn;
    const float dist = dn - ra - ctl(CT.bc_rb[e]);
    for (int a = 0; a < 3; ++a) pt[a] = pa[a] + nrm[a] * (ra + 0.5f * dist);
    return dist;
  }
  float qb_l[4], sz[3];
  ctl_vec<4>(CT.bc_qb[e], qb_l);
  ctl_vec<3>(CT.bc_sb[e], sz);
  float bpos[3], bq[4], loc[3], dv[3], cl[3], fd[3], sg[3];
  quat_rot(xquat[bb], pb_l, bpos);
  for (int a = 0; a < 3; ++a) bpos[a] = xpos[bb][a] + bpos[a];
  quat_mul(xquat[bb], qb_l, bq);
  const float bqc[4] = {bq[0], -bq[1], -bq[2], -bq[3]};
  for (int a = 0; a < 3; ++a) dv[a] = ca[a] - bpos[a];
  quat_rot(bqc, dv, loc);
  for (int a = 0; a < 3; ++a) {
    cl[a] = clampf(loc[a], -sz[a], sz[a]);
    dv[a] = loc[a] - cl[a];
    fd[a] = sz[a] - fabsf(loc[a]);
    sg[a] = loc[a] >= 0.0f ? 1.0f : -1.0f;
  }
  const float dn = norm3_eps(dv);
  const bool outside = dn > BODY_OUTSIDE;
  const bool m01 = fd[0] < fd[1];
  const bool m02 = fminf(fd[0], fd[1]) < fd[2];
  const float n_in[3] = {m01 && m02 ? sg[0] : 0.0f,
                         !m01 && m02 ? sg[1] : 0.0f, !m02 ? sg[2] : 0.0f};
  const float depth = m02 ? (m01 ? fd[0] : fd[1]) : fd[2];
  float nl[3], cpl[3], nw[3], cpw[3];
  for (int a = 0; a < 3; ++a) {
    nl[a] = outside ? dv[a] / dn : n_in[a];
    cpl[a] = outside ? cl[a] : (n_in[a] != 0.0f ? sg[a] * sz[a] : loc[a]);
  }
  const float dist = (outside ? dn : -depth) - ra;
  quat_rot(bq, nl, nw);      // from the box toward the point
  quat_rot(bq, cpl, cpw);
  const bool flip = ctl(CT.bc_flip[e]) != 0;
  for (int a = 0; a < 3; ++a) {
    pt[a] = (bpos[a] + cpw[a]) + nw[a] * (0.5f * dist);
    nrm[a] = flip ? nw[a] : -nw[a];
  }
  return dist;
}
#endif

// Contact point, frame (normal, tangent 1, tangent 2) and gap of contact
// ci: a ground point against its plane, or a body entry with its frame
// built from the traced normal (e the axis least aligned with it).
struct Frame {
  float gap;
  float p[3];
  float dirs[3][3];
};

__device__ __forceinline__ void contact_frame(const Work& W, int ci,
                                              Frame* f) {
#if BODY
  if (ci >= NCON) {
    const int e = ci - NCON;
    const float dist = body_contact(e, W.xpos, W.xquat, f->p, f->dirs[0]);
    const float cnd = fabsf(f->dirs[0][0]) < 0.5f ? 1.0f : 0.0f;
    const float ev[3] = {cnd, 1.0f - cnd, 0.0f};
    cross3(f->dirs[0], ev, f->dirs[1]);
    const float tn = norm3_eps(f->dirs[1]);
    for (int a = 0; a < 3; ++a) f->dirs[1][a] = f->dirs[1][a] / tn;
    cross3(f->dirs[0], f->dirs[1], f->dirs[2]);
    f->gap = dist - ctl(CT.con_incm[ci]);
    return;
  }
#endif
  const int bid = ctl(CT.con_body[ci]);
  float gp[3], pp[3];
  ctl_vec<3>(CT.con_geompos[ci], gp);
  ctl_vec<3>(CT.con_planepos[ci], pp);
  ctl_vec<9>(&CT.con_dirs[ci][0][0], &f->dirs[0][0]);
  const float* nrm = f->dirs[0];
  float gpos[3];
  quat_rot(W.xquat[bid], gp, gpos);
  for (int a = 0; a < 3; ++a) gpos[a] += W.xpos[bid][a];
  const float r0 = ctl(CT.con_radius[ci]);
  const float h_c = nrm[0] * (gpos[0] - pp[0]) + nrm[1] * (gpos[1] - pp[1]) +
                    nrm[2] * (gpos[2] - pp[2]);
  const float dist = h_c - r0;
  f->gap = dist - ctl(CT.con_incm[ci]);
  for (int a = 0; a < 3; ++a) f->p[a] = gpos[a] - nrm[a] * (r0 + 0.5f * dist);
}

// Row storage of one candidate: the first ROWCAP rows and BLKCAP blocks in
// shared memory, the rest in its slice of the global workspace.
struct Store {
  Row* rs;
  Blk* bs;
  Row* rg;
  Blk* bg;
  __device__ __forceinline__ Row* row(int r) const {
    return r < ROWCAP ? rs + r : rg + (r - ROWCAP);
  }
  __device__ __forceinline__ Blk* blk(int e) const {
    return e < BLKCAP ? bs + e : bg + (e - BLKCAP);
  }
};

// Scalar rows and elliptic blocks of contact ci.
__device__ __forceinline__ void contact_counts(int ci, int* nrows,
                                               int* nblks) {
  const int condim = ctl(CT.con_condim[ci]);
  *nrows = condim == 1 ? 1 : (CONE == 1 ? 0 : 2 * (condim - 1));
  *nblks = condim != 1 && CONE == 1 ? 1 : 0;
}

// The rows of active contact ci (its scalar rows from row r0 on, or its
// elliptic block at e0): direction Jacobians over the supporting dofs
// (normal, tangent 1, tangent 2, then rotations about the same dirs),
// written dense over the dofs, and the rows' reference accelerations and
// gated stiffnesses. One lane writes one contact's rows.
__device__ void emit_contact(const Work& W, const Store& st, int ci, int r0,
                             int e0) {
  Frame f;
  contact_frame(W, ci, &f);
  const int condim = ctl(CT.con_condim[ci]);
  const int ns = ctl(CT.con_nsup[ci]);
  const int nf = condim - 1;
  float imp[9];
  ctl_vec<9>(CT.con_imp[ci], imp);
  // the bodies whose motion moves the point, and the point about each
  // one's root subtree com; a ground point has only b2 (b1 is the world)
  int b1 = 0, b2;
  float r1[3] = {0.0f, 0.0f, 0.0f}, r2[3];
  float vd[6];
  const bool ground = ci < NCON;
  if (ground) {
    b2 = ctl(CT.con_body[ci]);
    const float* rf = W.subtree_com[tb.body_rootid[b2]];
    for (int a = 0; a < 3; ++a) r2[a] = f.p[a] - rf[a];
    float pv[3];
    cross3(W.cvel[b2], r2, pv);
    for (int a = 0; a < 3; ++a) pv[a] += W.cvel[b2][3 + a];
    for (int d = 0; d < 3; ++d) {
      vd[d] = dot3(pv, f.dirs[d]);
      vd[3 + d] = dot3(W.cvel[b2], f.dirs[d]);
    }
  } else {
#if BODY
    b1 = ctl(CT.bc_b1[ci - NCON]);
    b2 = ctl(CT.bc_b2[ci - NCON]);
    const float* rf1 = W.subtree_com[tb.body_rootid[b1]];
    const float* rf2 = W.subtree_com[tb.body_rootid[b2]];
    for (int a = 0; a < 3; ++a) {
      r1[a] = f.p[a] - rf1[a];
      r2[a] = f.p[a] - rf2[a];
    }
    float v1[3], v2[3], pv[3], wrel[3];
    cross3(W.cvel[b1], r1, v1);
    cross3(W.cvel[b2], r2, v2);
    for (int a = 0; a < 3; ++a) {
      pv[a] = (W.cvel[b2][3 + a] + v2[a]) - (W.cvel[b1][3 + a] + v1[a]);
      wrel[a] = W.cvel[b2][a] - W.cvel[b1][a];
    }
    for (int d = 0; d < 3; ++d) {
      vd[d] = dot3(pv, f.dirs[d]);
      vd[3 + d] = dot3(wrel, f.dirs[d]);
    }
#else
    b2 = 0;
#endif
  }
  // the rows' supports: the contact's supporting dofs
  const bool block = condim != 1 && CONE == 1;
  const int nrows = condim == 1 ? 1 : 2 * nf;
  unsigned sup[MW];
  for (int w = 0; w < MW; ++w) sup[w] = 0u;
  for (int il = 0; il < ns; ++il) {
    const int dof = ctl(CT.con_sup[ci][il]);
    sup[dof >> 5] |= 1u << (dof & 31);
  }
  for (int w = 0; w < MW; ++w) {
    if (block) {
      st.blk(e0)->sup[w] = sup[w];
    } else {
      for (int q = 0; q < nrows; ++q) st.row(r0 + q)->sup[w] = sup[w];
    }
  }

  const int p0 = block || condim == 1 ? 0 : ctl(CT.con_prow[ci]);
  for (int il = 0; il < ns; ++il) {
    const int dof = ctl(CT.con_sup[ci][il]);
    const float* cd = W.cdof[dof];
    float jd[6];
    if (ground) {
      float jp[3];
      cross3(cd, r2, jp);
      for (int a = 0; a < 3; ++a) jp[a] += cd[3 + a];
      for (int d = 0; d < 3; ++d) {
        jd[d] = dot3(jp, f.dirs[d]);
        jd[3 + d] = dot3(cd, f.dirs[d]);
      }
    } else {
      // b2's term plus, b1's minus, as the JAX kernel sums them
      const bool on2 = tb.body_dofmask[b2][dof] != 0;
      const bool on1 = tb.body_dofmask[b1][dof] != 0;
      float jp1[3], jp2[3];
      cross3(cd, r2, jp2);
      cross3(cd, r1, jp1);
      for (int a = 0; a < 3; ++a) {
        jp2[a] += cd[3 + a];
        jp1[a] += cd[3 + a];
      }
      for (int dd = 0; dd < 3; ++dd) {
        float lin = 0.0f, ang = 0.0f;
        if (on2) {
          lin = dot3(jp2, f.dirs[dd]);
          ang = dot3(cd, f.dirs[dd]);
        }
        if (on1) {
          lin = on2 ? lin - dot3(jp1, f.dirs[dd]) : -dot3(jp1, f.dirs[dd]);
          ang = on2 ? ang - dot3(cd, f.dirs[dd]) : -dot3(cd, f.dirs[dd]);
        }
        jd[dd] = lin;
        jd[3 + dd] = ang;
      }
    }
    if (condim == 1) {
      st.row(r0)->J[dof] = jd[0];
    } else if (block) {
      // rows past the contact's own friction axes are zero
      Blk* B = st.blk(e0);
      B->J[0][dof] = jd[0];
      for (int a = 0; a < EROWS - 1; ++a)
        B->J[1 + a][dof] = a < nf ? jd[1 + a] : 0.0f;
    } else {
      for (int a = 0; a < nf; ++a)
        for (int s = 0; s < 2; ++s) {
          const float smu = ctl(CT.prow_smu[p0 + 2 * a + s]);
          st.row(r0 + 2 * a + s)->J[dof] = jd[0] + smu * jd[1 + a];
        }
    }
  }
  if (condim == 1) {
    Row* R = st.row(r0);
    kbi(f.gap, vd[0], imp, ctl(CT.con_invw[ci]), &R->aref, &R->d);
  } else if (block) {
    Blk* B = st.blk(e0);
    B->ci = ci;
    kbi(f.gap, vd[0], imp, ctl(CT.con_invw[ci]), &B->aref[0], &B->dn);
    for (int a = 0; a < EROWS - 1; ++a)
      B->aref[1 + a] = a < nf ? -imp[IMP_B] * vd[1 + a] : 0.0f;
  } else {
    const float iw = ctl(CT.con_iw[ci]);
    for (int a = 0; a < nf; ++a)
      for (int s = 0; s < 2; ++s) {
        const float smu = ctl(CT.prow_smu[p0 + 2 * a + s]);
        Row* R = st.row(r0 + 2 * a + s);
        kbi(f.gap, vd[0] + smu * vd[1 + a], imp, iw, &R->aref, &R->d);
      }
  }
}

// Section timing (LR_PROFILE=1, off in normal builds): lane 0 of every
// team adds the clock64() cycles it spends in each section of each step to
// its own counters, and at the end to lane_prof (sums over the teams; slot
// 25 the largest team total), read back with lane_profile(); the machine
// may have no profiler that can attach, and the teams' latency sets the
// launch time. Sections: 0 control + forward kinematics, 1 com quantities,
// 2 inertias + motion subspaces, 3 mass matrix, 4 velocities + RNE,
// 5 passive + actuation, 6 residual + outputs, 7 cull (gaps), 8 rows
// (Jacobians), 9 unconstrained solve, 10 Newton row passes, 11 gradient +
// Hessian, 12 Newton Cholesky, 13 line search, 14 constraint force,
// 15 Euler; 19 prologue. Slots 20.. count active rows over every candidate
// and step: 20 scalar rows, 21 their maximum, 22 elliptic blocks, 23 their
// maximum, 24 steps with any active row.
#define PROFILE_SLOTS 26
#if PROFILE
__device__ unsigned long long lane_prof[PROFILE_SLOTS];
#define TICK(n)                                                          \
  do {                                                                   \
    if (tm.lane == 0) {                                                  \
      const long long now_ = clock64();                                  \
      prof_acc[prof_slot] += (unsigned long long)(now_ - prof_t);        \
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

// ---------------------------------------------------------------- kernel --

extern "C" __global__ void __launch_bounds__(MAXTHREADS)
lane_rollout_kernel(const float* __restrict__ qpos0,
                    const float* __restrict__ qvel0,
                    const float* __restrict__ values,
                    const float* __restrict__ aux_in,
                    const float* __restrict__ table,
                    float* __restrict__ out0, float* __restrict__ out1,
                    float* __restrict__ ws, int K) {
  // one thread stages the tables; every thread waits for the generic ones
  uint64_t* bars = reinterpret_cast<uint64_t*>(lr_smem);
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    if (kCtStaged) mbar_init(&bars[1]);
    bulk_copy_to_shared(lr_smem + kHeadOff, lr_tables, kHead16, &bars[0]);
    if (kCtStaged)
      bulk_copy_to_shared(lr_smem + kCtabOff, lr_tables + kHead16, kCtab16,
                          &bars[1]);
  }
  __syncthreads();
  const Team tm = make_team(threadIdx.x);
  const int team = threadIdx.x / TEAM;
  const int k = blockIdx.x * (blockDim.x / TEAM) + team;
  mbar_wait(&bars[0]);
  bool ct_ready = !kCtStaged;
  if (k >= K) {
    // no thread leaves while a copy into its block's memory is in flight
    if (!ct_ready) mbar_wait(&bars[1]);
    return;
  }
  Work& W = *reinterpret_cast<Work*>(lr_smem + kWorkOff + team * kWork16);
  float* wsk = ws + (size_t)k * kWsFloats;
  const Store st{W.rows, W.blks, reinterpret_cast<Row*>(wsk),
                 reinterpret_cast<Blk*>(wsk + kOvfRows * sizeof(Row) /
                                                  sizeof(float))};
  const int ln = tm.lane;
  const TaskConst& tc = task_tb;
  const float h = tb.timestep[0];
#if PROFILE
  unsigned long long prof_acc[20] = {};
  int prof_slot = 19;
  long long prof_t = clock64();
#endif

  for (int i = ln; i < NQ; i += TEAM) W.qpos[i] = qpos0[i * K + k];
  for (int i = ln; i < NV; i += TEAM) W.qvel[i] = qvel0[i * K + k];
  if (NR > 0) {
    for (int i = ln; i < NAUXS; i += TEAM) W.aux[i] = aux_in[i * K + k];
    for (int i = ln; i < 2 * NTERM; i += TEAM)
      W.aux[NAUXS + i] = aux_in[(NAUX + i) * K + k];
  }
  for (int i = ln; i < NTERM; i += TEAM) W.sums[i] = 0.0f;
#if CTRL
  const float fb_alpha = values[k], fb_scale = values[K + k];
#endif

  for (int t = 0; t < H; ++t) {
    team_sync(tm);
#if CTRL
    {
      // feedback law on the tangent difference to the nominal state
      const float* row = table + (size_t)t * STRIDE;
      const float* xn = row + 2 * NU + NU * NDX;
      for (int j = ln; j < NJNT; j += TEAM) {
        const int qa = tb.jnt_qposadr[j], da = tb.jnt_dofadr[j];
        if (tb.jnt_type[j] == JNT_FREE) {
          for (int a = 0; a < 3; ++a)
            W.dx[da + a] = W.qpos[qa + a] - __ldg(xn + qa + a);
          const float qn[4] = {__ldg(xn + qa + 3), __ldg(xn + qa + 4),
                               __ldg(xn + qa + 5), __ldg(xn + qa + 6)};
          quat_sub_tangent(W.qpos + qa + 3, qn, W.dx + da + 3);
        } else {
          W.dx[da] = W.qpos[qa] - __ldg(xn + qa);
        }
      }
      for (int i = ln; i < NV; i += TEAM)
        W.dx[NV + i] = W.qvel[i] - __ldg(xn + NQ + i);
      team_sync(tm);
      for (int u = ln; u < NU; u += TEAM) {
        const float cff = __ldg(row + u) + fb_alpha * __ldg(row + NU + u);
        const float* g = row + 2 * NU + u * NDX;
        float acc = __ldg(g) * W.dx[0];
        for (int i = 1; i < NDX; ++i) acc += __ldg(g + i) * W.dx[i];
        W.ctrl[u] = clampf(cff + fb_scale * acc, tb.act_ctrlrange[u][0],
                           tb.act_ctrlrange[u][1]);
      }
    }
#else
    {
      int node = (t * P) / ((H - 1) > 1 ? (H - 1) : 1);
      node = node < P - 1 ? node : P - 1;
      for (int u = ln; u < NU; u += TEAM)
        W.ctrl[u] = values[(node * NU + u) * K + k];
    }
#endif
    TICK(0);
    // ---- forward kinematics, level by level down the tree ----
    if (ln == 0) {
      W.xpos[0][0] = W.xpos[0][1] = W.xpos[0][2] = 0.0f;
      W.xquat[0][0] = 1.0f;
      W.xquat[0][1] = W.xquat[0][2] = W.xquat[0][3] = 0.0f;
    }
    for (int lv = 1; lv <= NLVL; ++lv) {
      team_sync(tm);
      for_level(tm, lv, [&](int i) {
        const int pid = tb.body_parentid[i];
        float pos[3], quat[4], tmp[3];
        quat_rot(W.xquat[pid], tb.body_pos[i], tmp);
        for (int a = 0; a < 3; ++a) pos[a] = W.xpos[pid][a] + tmp[a];
        quat_mul(W.xquat[pid], tb.body_quat[i], quat);
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
            const float* q = W.qpos + qadr;
            for (int a = 0; a < 3; ++a) pos[a] = q[a];
            const float qn = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] +
                                   q[6] * q[6]);
            const float inv = 1.0f / fmaxf(qn, 1e-12f);
            for (int a = 0; a < 4; ++a) quat[a] = q[3 + a] * inv;
            for (int a = 0; a < 3; ++a) {
              anchor[a] = pos[a];
              axis[a] = tb.jnt_axis[j][a];  // global, not rotated
            }
          } else if (jtype == JNT_SLIDE) {
            const float disp = W.qpos[qadr] - tb.qpos0[qadr];
            for (int a = 0; a < 3; ++a) pos[a] += axis[a] * disp;
          } else {  // hinge
            const float half = 0.5f * (W.qpos[qadr] - tb.qpos0[qadr]);
            const float s = sinf(half);
            const float qloc[4] = {cosf(half), tb.jnt_axis[j][0] * s,
                                   tb.jnt_axis[j][1] * s,
                                   tb.jnt_axis[j][2] * s};
            quat_mul(quat, qloc, quat);
            quat_rot(quat, tb.jnt_pos[j], tmp);
            for (int a = 0; a < 3; ++a) pos[a] = anchor[a] - tmp[a];
          }
          for (int a = 0; a < 3; ++a) {
            W.xanchor[j][a] = anchor[a];
            W.xaxis[j][a] = axis[a];
          }
        }
        for (int a = 0; a < 3; ++a) W.xpos[i][a] = pos[a];
        for (int a = 0; a < 4; ++a) W.xquat[i][a] = quat[a];
      });
    }
    team_sync(tm);
    TICK(1);
    // ---- com quantities ----
    for (int i = ln; i < NBODY; i += TEAM) {
      quat_rot(W.xquat[i], tb.body_ipos[i], W.xipos[i]);
      for (int a = 0; a < 3; ++a) {
        W.xipos[i][a] += W.xpos[i][a];
        W.subtree_com[i][a] = W.xipos[i][a] * tb.body_mass[i];
      }
    }
    team_sync(tm);
    team_tree_sum<3>(tm, W.subtree_com, true);
    for (int i = ln; i < NBODY; i += TEAM)
      for (int a = 0; a < 3; ++a)
        W.subtree_com[i][a] *= tb.body_invsubtreemass[i];
    team_sync(tm);
    TICK(2);
    // ---- spatial inertia about the root's subtree com, per body ----
    for (int i = 1 + ln; i < NBODY; i += TEAM) {
      float quat[4];
      quat_mul(W.xquat[i], tb.body_iquat[i], quat);
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
      const float* rf = W.subtree_com[tb.body_rootid[i]];
      const float d[3] = {W.xipos[i][0] - rf[0], W.xipos[i][1] - rf[1],
                          W.xipos[i][2] - rf[2]};
      const float d2 = dot3(d, d);
      float* ci = W.cinert[i];
      ci[0] = I[0] + mass * d2 - mass * d[0] * d[0];
      ci[1] = I[1] - mass * d[0] * d[1];
      ci[2] = I[2] - mass * d[0] * d[2];
      ci[3] = I[3] + mass * d2 - mass * d[1] * d[1];
      ci[4] = I[4] - mass * d[1] * d[2];
      ci[5] = I[5] + mass * d2 - mass * d[2] * d[2];
      ci[6] = d[0] * mass;
      ci[7] = d[1] * mass;
      ci[8] = d[2] * mass;
      ci[9] = mass;
      for (int a = 0; a < 10; ++a) W.crb[i][a] = ci[a];
    }
    // ---- motion subspace per dof (angular 0..2, linear 3..5) ----
    for (int j = ln; j < NJNT; j += TEAM) {
      const int bid = tb.jnt_bodyid[j];
      const int jtype = tb.jnt_type[j];
      const int da = tb.jnt_dofadr[j];
      const float* rf = W.subtree_com[tb.body_rootid[bid]];
      const float offset[3] = {rf[0] - W.xanchor[j][0],
                               rf[1] - W.xanchor[j][1],
                               rf[2] - W.xanchor[j][2]};
      if (jtype == JNT_SLIDE) {
        for (int a = 0; a < 3; ++a) {
          W.cdof[da][a] = 0.0f;
          W.cdof[da][3 + a] = W.xaxis[j][a];
        }
      } else if (jtype == JNT_HINGE) {
        for (int a = 0; a < 3; ++a) W.cdof[da][a] = W.xaxis[j][a];
        cross3(W.xaxis[j], offset, &W.cdof[da][3]);
      } else {  // free: world translations, then body-frame rotation axes
        for (int kk = 0; kk < 3; ++kk) {
          for (int a = 0; a < 6; ++a) W.cdof[da + kk][a] = 0.0f;
          W.cdof[da + kk][3 + kk] = 1.0f;
          float e[3] = {0.0f, 0.0f, 0.0f};
          e[kk] = 1.0f;
          quat_rot(W.xquat[bid], e, &W.cdof[da + 3 + kk][0]);
          cross3(&W.cdof[da + 3 + kk][0], offset, &W.cdof[da + 3 + kk][3]);
        }
      }
    }
    team_sync(tm);
    TICK(3);
    // ---- composite inertias up the tree and the mass matrix, per entry --
    team_tree_sum<10>(tm, W.crb, false);
    for (int i = ln; i < NV; i += TEAM)
      inertia_mul(W.crb[tb.dof_bodyid[i]], W.cdof[i], W.fm[i]);
    team_sync(tm);
    team_for_tri(tm, NV, [&](int i, int j) {
      float val = 0.0f;
      if (tb.dof_anc[i][j])
        val = dot3(W.fm[i], W.cdof[j]) + dot3(W.fm[i] + 3, W.cdof[j] + 3);
      if (i == j) val += tb.dof_armature[i];
      W.M[i][j] = val;
      W.M[j][i] = val;
    });
    TICK(4);
    // ---- body velocities, cdof_dot, accelerations, level by level ----
    if (ln == 0) {
      for (int a = 0; a < 6; ++a) W.cvel[0][a] = 0.0f;
      for (int a = 0; a < 3; ++a) {
        W.cacc[0][a] = 0.0f;
        W.cacc[0][3 + a] = -tb.gravity[a];
      }
    }
    for (int lv = 1; lv <= NLVL; ++lv) {
      team_sync(tm);
      for_level(tm, lv, [&](int i) {
        const int pid = tb.body_parentid[i];
        float v[6];
        for (int a = 0; a < 6; ++a) v[a] = W.cvel[pid][a];
        const int da = tb.body_dofadr[i];
        const int nd = tb.body_dofnum[i];
        int kk = 0;
        while (kk < nd) {
          const int n = da + kk;
          if (tb.jnt_type[tb.dof_jntid[n]] == JNT_FREE) {
            for (int d = 0; d < 3; ++d) {   // translations: cdof_dot = 0
              for (int a = 0; a < 6; ++a) {
                W.cdof_dot[da + d][a] = 0.0f;
                v[a] += W.cdof[da + d][a] * W.qvel[da + d];
              }
            }
            float vpre[6];
            for (int a = 0; a < 6; ++a) vpre[a] = v[a];
            for (int d = 3; d < 6; ++d) {   // rotations: pre-velocity =
              motion_cross(vpre, W.cdof[da + d], W.cdof_dot[da + d]);
              for (int a = 0; a < 6; ++a)     // translations
                v[a] += W.cdof[da + d][a] * W.qvel[da + d];
            }
            kk += 6;
          } else {
            motion_cross(v, W.cdof[n], W.cdof_dot[n]);
            for (int a = 0; a < 6; ++a) v[a] += W.cdof[n][a] * W.qvel[n];
            kk += 1;
          }
        }
        for (int a = 0; a < 6; ++a) W.cvel[i][a] = v[a];
        for (int a = 0; a < 6; ++a) W.cacc[i][a] = W.cacc[pid][a];
        for (int d = 0; d < nd; ++d)
          for (int a = 0; a < 6; ++a)
            W.cacc[i][a] += W.cdof_dot[da + d][a] * W.qvel[da + d];
      });
    }
    team_sync(tm);
    // ---- RNE forces per body, summed up the tree ----
    for (int a = ln; a < 6; a += TEAM) W.cfrc[0][a] = 0.0f;
    for (int i = 1 + ln; i < NBODY; i += TEAM) {
      float iv[6], ia[6], t0[3], t1[3];
      inertia_mul(W.cinert[i], W.cvel[i], iv);
      inertia_mul(W.cinert[i], W.cacc[i], ia);
      // force cross: (w x t + v x f, w x f)
      cross3(W.cvel[i], iv, t0);
      cross3(W.cvel[i] + 3, iv + 3, t1);
      for (int a = 0; a < 3; ++a) W.cfrc[i][a] = ia[a] + (t0[a] + t1[a]);
      cross3(W.cvel[i], iv + 3, t0);
      for (int a = 0; a < 3; ++a) W.cfrc[i][3 + a] = ia[3 + a] + t0[a];
    }
    team_sync(tm);
    team_tree_sum<6>(tm, W.cfrc, false);
    TICK(5);
    // ---- passive + actuation (lane 0); rhs = passive + actuation - bias --
    if (ln == 0) {
      float* qfrc = W.vb;   // scratch until the solve
      for (int i = 0; i < NV; ++i) qfrc[i] = 0.0f;
      for (int j = 0; j < NJNT; ++j) {
        const int qadr = tb.jnt_qposadr[j], dadr = tb.jnt_dofadr[j];
        qfrc[dadr] -= tb.jnt_stiffness[j] *
                      (W.qpos[qadr] - tb.qpos_spring[qadr]);
      }
      for (int i = 0; i < NV; ++i) qfrc[i] -= tb.dof_damping[i] * W.qvel[i];
#if FLUID
      // inertia-box fluid model: viscous and quadratic drag in each body's
      // inertial frame, applied at its com (coefficients from the host)
      for (int i = 1; i < NBODY; ++i) {
        if (!tb.fluid_on[i]) continue;
        const float* rf = W.subtree_com[tb.body_rootid[i]];
        const float off[3] = {W.xipos[i][0] - rf[0], W.xipos[i][1] - rf[1],
                              W.xipos[i][2] - rf[2]};
        float v_w[3], qw[4], la[3], ll[3], tq[3], fr[3], f_w[3], t_ref[3];
        cross3(W.cvel[i], off, v_w);
        for (int a = 0; a < 3; ++a)
          v_w[a] = (W.cvel[i][3 + a] + v_w[a]) - tb.wind[a];
        quat_mul(W.xquat[i], tb.body_iquat[i], qw);
        const float qc[4] = {qw[0], -qw[1], -qw[2], -qw[3]};
        quat_rot(qc, W.cvel[i], la);
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
            qfrc[d] += dot3(W.cdof[d], t_ref) + dot3(W.cdof[d] + 3, f_w);
      }
#endif
      for (int u = 0; u < NU; ++u) {
        float uin = W.ctrl[u];
        if (tb.act_ctrllimited[u])
          uin = clampf(uin, tb.act_ctrlrange[u][0], tb.act_ctrlrange[u][1]);
        const int dadr = tb.act_dadr[u];
        const float gear = tb.act_gear[u];
        float length = W.qpos[tb.act_qadr[u]] * gear;
        float velocity = W.qvel[dadr] * gear;
#if SITE
        // site transmission: the gear's wrench at the site, in world
        // coordinates; its moment over the site body's dofs (kept in
        // acc0 until the force is known), length 0
        float* moment = W.acc0;
        const bool at_site = tb.act_site[u] != 0;
        if (at_site) {
          const int bid = tb.act_sitebody[u];
          float wq[4], f_w[3], t_ref[3], spos[3], rxf[3];
          quat_mul(W.xquat[bid], tb.act_sitequat[u], wq);
          quat_rot(wq, tb.act_gear6[u], f_w);
          quat_rot(wq, tb.act_gear6[u] + 3, t_ref);
          quat_rot(W.xquat[bid], tb.act_sitepos[u], spos);
          const float* rf = W.subtree_com[tb.body_rootid[bid]];
          for (int a = 0; a < 3; ++a)
            spos[a] = (spos[a] + W.xpos[bid][a]) - rf[a];
          cross3(spos, f_w, rxf);
          for (int a = 0; a < 3; ++a) t_ref[a] += rxf[a];
          length = 0.0f;
          velocity = 0.0f;
          for (int d = 0; d < NV; ++d) {
            moment[d] = tb.body_dofmask[bid][d]
                ? dot3(W.cdof[d], t_ref) + dot3(W.cdof[d] + 3, f_w) : 0.0f;
            velocity += moment[d] * W.qvel[d];
          }
        }
#endif
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
        W.act_force[u] = force;
#if SITE
        if (at_site) {
          for (int d = 0; d < NV; ++d)
            if (tb.body_dofmask[tb.act_sitebody[u]][d])
              qfrc[d] += moment[d] * force;
          continue;
        }
#endif
        qfrc[dadr] += gear * force;
      }
    }
    team_sync(tm);
    for (int i = ln; i < NV; i += TEAM) {
      const float* fb = W.cfrc[tb.dof_bodyid[i]];
      const float bias = dot3(W.cdof[i], fb) + dot3(W.cdof[i] + 3, fb + 3);
      W.rhs[i] = W.vb[i] - bias;
    }
    TICK(6);
    // ---- task residual on the pre-step state (lane 0); outputs ----
    if (NR > 0 && ln == 0) {
      StepCtx ctx;
      ctx.qpos = W.qpos; ctx.qvel = W.qvel; ctx.ctrl = W.ctrl;
      ctx.xpos = W.xpos; ctx.xquat = W.xquat; ctx.xipos = W.xipos;
      ctx.subtree_com = W.subtree_com; ctx.cvel = W.cvel;
      ctx.act_force = W.act_force; ctx.aux = W.aux; ctx.aux_rows = aux_in;
      ctx.K = K; ctx.k = k; ctx.t = t;
      task_residual(ctx, tc, W.res);
    }
    team_sync(tm);
    if (MODE == 0) {
      float* o = out0 + (size_t)t * (NQ + NV + NR) * K + k;
      for (int i = ln; i < NQ + NV + NR; i += TEAM)
        o[(size_t)i * K] = i < NQ ? W.qpos[i]
            : (i < NQ + NV ? W.qvel[i - NQ] : W.res[i - NQ - NV]);
    } else if (MODE == 1) {
      float* o = out0 + (size_t)t * NR * K + k;
      for (int i = ln; i < NR; i += TEAM) o[(size_t)i * K] = W.res[i];
    } else {
      for (int n = ln; n < NTERM; n += TEAM) {
        int off = 0;
        for (int m = 0; m < n; ++m) off += tb.term_dim[m];
        W.sums[n] += term_cost(W.res + off, tb.term_dim[n], tb.term_type[n],
                               W.aux[NAUXS + 2 * n], W.aux[NAUXS + 2 * n + 1]);
      }
    }

#if HAS_ROWS
    TICK(7);
    // ---- the cull: active limit sides and contacts, in serial order ----
    // limit side r = 2 l + s touches dof lim_dadr[l] with sign +-1
    const int nlim = team_compact(tm, NLIM, [&](int r) {
      const int l = r >> 1, qadr = tb.lim_qadr[l];
      const float pos = (r & 1)
          ? tb.lim_hi[l] - W.qpos[qadr] - tb.lim_margin[l]
          : W.qpos[qadr] - tb.lim_lo[l] - tb.lim_margin[l];
      return !(pos >= 0.0f);
    }, W.lim_list);
    if (!ct_ready) {
      mbar_wait(&bars[1]);
      ct_ready = true;
    }
    const int ncon = team_compact(tm, NCT, [&](int ci) {
      Frame f;
      contact_frame(W, ci, &f);
      return !(f.gap >= 0.0f);
    }, W.con_list);
    TICK(8);
    // ---- the rows of the active limit sides and contacts ----
    for (int i = ln; i < nlim; i += TEAM) {
      const int r = W.lim_list[i], l = r >> 1, qadr = tb.lim_qadr[l];
      const int dadr = tb.lim_dadr[l];
      const float sg = (r & 1) ? -1.0f : 1.0f;
      const float pos = (r & 1)
          ? tb.lim_hi[l] - W.qpos[qadr] - tb.lim_margin[l]
          : W.qpos[qadr] - tb.lim_lo[l] - tb.lim_margin[l];
      Row* R = st.row(i);
      for (int w = 0; w < MW; ++w) R->sup[w] = 0u;
      R->sup[dadr >> 5] = 1u << (dadr & 31);
      R->J[dadr] = sg;
      kbi(pos, sg * W.qvel[dadr], tb.lim_imp[l], tb.lim_invw[l], &R->aref,
          &R->d);
    }
    int nrow = nlim, nblk = 0;
    for (int base = 0; base < ncon; base += TEAM) {
      const int i = base + ln;
      const int ci = i < ncon ? W.con_list[i] : -1;
      int wr = 0, wb = 0;
      if (ci >= 0) contact_counts(ci, &wr, &wb);
      int tr, tbk;
      const int orow = team_scan(tm, wr, &tr);
      const int oblk = team_scan(tm, wb, &tbk);
      if (ci >= 0) emit_contact(W, st, ci, nrow + orow, nblk + oblk);
      nrow += tr;
      nblk += tbk;
    }
#if PROFILE
    if (ln == 0) {
      atomicAdd(&lane_prof[20], (unsigned long long)nrow);
      atomicMax(&lane_prof[21], (unsigned long long)nrow);
      atomicAdd(&lane_prof[22], (unsigned long long)nblk);
      atomicMax(&lane_prof[23], (unsigned long long)nblk);
      atomicAdd(&lane_prof[24], (unsigned long long)(nrow + nblk > 0));
    }
#endif
    team_sync(tm);
    TICK(9);
    if (nrow + nblk > 0) {
      // ---- Newton on the acceleration ----
      team_for_tri(tm, NV, [&](int i, int j) { W.Hm[i][j] = W.M[i][j]; });
      team_chol_solve<NVP, NVP>(tm, W.Hm, W.rhs, W.acc0, W.dinv);
      for (int i = ln; i < NV; i += TEAM) W.acc[i] = W.acc0[i];
      for (int it = 0; it < N_NEWTON; ++it) {
        team_sync(tm);
        TICK(10);
        for (int i = ln; i < NV; i += TEAM) {
          float s = 0.0f;
          for (int j = 0; j < NV; ++j) s += W.M[i][j] * (W.acc[j] - W.acc0[j]);
          W.ma[i] = s;
        }
        for (int r = ln; r < nrow; r += TEAM) {
          Row* R = st.row(r);
          float jar = 0.0f;
          for_dofs(R->sup, [&](int i) { jar += R->J[i] * W.acc[i]; });
          R->jar = jar - R->aref;
        }
        for (int e = ln; e < nblk; e += TEAM) {
          Blk* B = st.blk(e);
          float jar[EROWS];
#pragma unroll
          for (int r = 0; r < EROWS; ++r) jar[r] = 0.0f;
          for_dofs(B->sup, [&](int i) {
            const float a = W.acc[i];
#pragma unroll
            for (int r = 0; r < EROWS; ++r) jar[r] += B->J[r][i] * a;
          });
#pragma unroll
          for (int r = 0; r < EROWS; ++r) {
            jar[r] -= B->aref[r];
            B->jar[r] = jar[r];
          }
          EllTerms et;
          ell_terms(jar, B->dn, B->ci, &et);
#pragma unroll
          for (int r = 0; r < EROWS; ++r) {
            B->g[r] = et.g[r];
            B->hd[r] = et.hd[r];
            B->gz[r] = et.gz[r];
            B->cs[r] = et.cs[r];
          }
          B->w_mid = et.w_mid;
          B->w_cone = et.w_cone;
        }
        team_sync(tm);
        for (int q = ln; q < nblk * NV; q += TEAM) {
          Blk* B = st.blk(q / NV);
          const int i = q % NV;
          float v = 0.0f, u = 0.0f;
          if (has_dof(B->sup, i)) {
#pragma unroll
            for (int r = 0; r < EROWS; ++r) {
              v += B->gz[r] * B->J[r][i];
              u += B->cs[r] * B->J[r][i];
            }
          }
          B->v[i] = v;
          B->u[i] = u;
        }
        team_sync(tm);
        TICK(11);
        // gradient: each dof owned by one lane, summed over the rows in
        // their serial order (rows whose act is 0 add zeros)
        for (int i = ln; i < NV; i += TEAM) {
          float g = 0.0f;
          for (int r = 0; r < nrow; ++r) {
            const Row* R = st.row(r);
            const float act = R->jar < 0.0f ? R->d : 0.0f;
            if (act != 0.0f && has_dof(R->sup, i))
              g += R->J[i] * (act * R->jar);
          }
          for (int e = 0; e < nblk; ++e) {
            const Blk* B = st.blk(e);
            if (!has_dof(B->sup, i)) continue;
            float gi = 0.0f;
#pragma unroll
            for (int r = 0; r < EROWS; ++r) gi += B->J[r][i] * B->g[r];
            g += gi;
          }
          W.vb[i] = W.ma[i] + g;
        }
        // Hessian: M plus each row's and block's outer product over its
        // support. Lane p owns the lower-triangle entries p, p + TEAM, ..
        // and sums each over the rows, then the blocks, in their serial
        // order, in registers (an entry off a row's support takes nothing
        // from it).
        {
          constexpr int kEnt = (NVP * (NVP + 1) / 2 + TEAM - 1) / TEAM;
          int ei[kEnt], ej[kEnt];
          float hv[kEnt];
          {
            int r = 0, c = ln;
            while (r < NV && c > r) { c -= r + 1; ++r; }
#pragma unroll
            for (int e = 0; e < kEnt; ++e) {
              ei[e] = r < NV ? r : -1;
              ej[e] = c;
              hv[e] = r < NV ? W.M[r][c] : 0.0f;
              c += TEAM;
              while (r < NV && c > r) { c -= r + 1; ++r; }
            }
          }
          for (int r = 0; r < nrow; ++r) {
            const Row* R = st.row(r);
            const float act = R->jar < 0.0f ? R->d : 0.0f;
            if (act == 0.0f) continue;
            unsigned sup[MW];
#pragma unroll
            for (int w = 0; w < MW; ++w) sup[w] = R->sup[w];
#pragma unroll
            for (int e = 0; e < kEnt; ++e)
              if (ei[e] >= 0 && has_dof(sup, ei[e]) && has_dof(sup, ej[e]))
                hv[e] += act * R->J[ej[e]] * R->J[ei[e]];
          }
          for (int b = 0; b < nblk; ++b) {
            const Blk* B = st.blk(b);
            unsigned sup[MW];
#pragma unroll
            for (int w = 0; w < MW; ++w) sup[w] = B->sup[w];
#pragma unroll
            for (int e = 0; e < kEnt; ++e) {
              if (ei[e] < 0 || !has_dof(sup, ei[e]) || !has_dof(sup, ej[e]))
                continue;
              const int i = ei[e], j = ej[e];
              float hij = 0.0f;
#pragma unroll
              for (int r = 0; r < EROWS; ++r)
                hij += (B->hd[r] * B->J[r][j]) * B->J[r][i];
              hij += (B->w_mid * B->v[j]) * B->v[i] -
                     (B->w_cone * B->u[j]) * B->u[i];
              hv[e] += hij;
            }
          }
#pragma unroll
          for (int e = 0; e < kEnt; ++e)
            if (ei[e] >= 0) W.Hm[ei[e]][ej[e]] = hv[e];
        }
        TICK(12);
        team_chol_solve<NVP, NVP>(tm, W.Hm, W.vb, W.pstep, W.dinv);
        for (int i = ln; i < NV; i += TEAM) W.pstep[i] = -W.pstep[i];
        team_sync(tm);
        float tls = 1.0f;
        TICK(13);
        if (N_LS > 0) {
          // Safeguarded exact line search along pstep: phi is convex and
          // piecewise quadratic, so phi' is monotone. The bracket of its
          // root is built from the N_LS Newton evaluations themselves;
          // until an upper bracket exists growth is capped at 4x.
          float ppmp = 0.0f, ppma = 0.0f, part = 0.0f;
          for (int i = ln; i < NV; i += TEAM) {
            float s = 0.0f;
            for (int j = 0; j < NV; ++j) s += W.M[i][j] * W.pstep[j];
            ppmp += W.pstep[i] * s;
            ppma += W.pstep[i] * W.ma[i];
          }
          for (int r = ln; r < nrow; r += TEAM) {
            Row* R = st.row(r);
            float s = 0.0f;
            for_dofs(R->sup, [&](int i) { s += R->J[i] * W.pstep[i]; });
            R->jps = s;
            const float act = R->jar < 0.0f ? R->d : 0.0f;
            part += act * R->jar * s;
          }
          for (int e = ln; e < nblk; e += TEAM) {
            Blk* B = st.blk(e);
            float jps[EROWS];
#pragma unroll
            for (int r = 0; r < EROWS; ++r) jps[r] = 0.0f;
            for_dofs(B->sup, [&](int i) {
              const float ps = W.pstep[i];
#pragma unroll
              for (int r = 0; r < EROWS; ++r) jps[r] += B->J[r][i] * ps;
            });
#pragma unroll
            for (int r = 0; r < EROWS; ++r) {
              B->jps[r] = jps[r];
              part += B->g[r] * jps[r];
            }
          }
          const float pmp = team_sum(tm, ppmp), pma = team_sum(tm, ppma);
          float dlo = pma + team_sum(tm, part);
          const float kBig = 1e6f;
          float lo = 0.0f, hi = kBig, dhi = 0.0f;
          for (int ls = 0; ls < N_LS; ++ls) {
            float pd = 0.0f, pdd = 0.0f;
            for (int r = ln; r < nrow; r += TEAM) {
              const Row* R = st.row(r);
              const float jart = R->jar + tls * R->jps;
              const float act = jart < 0.0f ? R->d : 0.0f;
              pd += act * jart * R->jps;
              pdd += act * R->jps * R->jps;
            }
            for (int e = ln; e < nblk; e += TEAM) {
              const Blk* B = st.blk(e);
              float jart[EROWS];
#pragma unroll
              for (int r = 0; r < EROWS; ++r)
                jart[r] = B->jar[r] + tls * B->jps[r];
              EllTerms et;
              ell_terms(jart, B->dn, B->ci, &et);
              float vp = 0.0f, up = 0.0f, hs = 0.0f;
#pragma unroll
              for (int r = 0; r < EROWS; ++r) {
                pd += et.g[r] * B->jps[r];
                vp += et.gz[r] * B->jps[r];
                up += et.cs[r] * B->jps[r];
                hs += et.hd[r] * B->jps[r] * B->jps[r];
              }
              pdd += hs + et.w_mid * vp * vp - et.w_cone * up * up;
            }
            const float dphi = (pma + tls * pmp) + team_sum(tm, pd);
            const float ddphi = pmp + team_sum(tm, pdd);
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
        for (int i = ln; i < NV; i += TEAM) W.acc[i] += tls * W.pstep[i];
      }
      team_sync(tm);
      TICK(14);
      // ---- constraint force back into the right-hand side ----
      for (int r = ln; r < nrow; r += TEAM) {
        Row* R = st.row(r);
        float jar = 0.0f;
        for_dofs(R->sup, [&](int i) { jar += R->J[i] * W.acc[i]; });
        jar -= R->aref;
        const float act = jar < 0.0f ? R->d : 0.0f;
        R->jar = act * jar;     // the row's force
      }
      for (int e = ln; e < nblk; e += TEAM) {
        Blk* B = st.blk(e);
        float jar[EROWS];
#pragma unroll
        for (int r = 0; r < EROWS; ++r) jar[r] = 0.0f;
        for_dofs(B->sup, [&](int i) {
          const float a = W.acc[i];
#pragma unroll
          for (int r = 0; r < EROWS; ++r) jar[r] += B->J[r][i] * a;
        });
#pragma unroll
        for (int r = 0; r < EROWS; ++r) jar[r] -= B->aref[r];
        EllTerms et;
        ell_terms(jar, B->dn, B->ci, &et);
#pragma unroll
        for (int r = 0; r < EROWS; ++r) B->g[r] = et.g[r];
      }
      team_sync(tm);
      for (int i = ln; i < NV; i += TEAM) {
        float s = W.rhs[i];
        for (int r = 0; r < nrow; ++r) {
          const Row* R = st.row(r);
          if (has_dof(R->sup, i)) s -= R->J[i] * R->jar;
        }
        for (int e = 0; e < nblk; ++e) {
          const Blk* B = st.blk(e);
          if (!has_dof(B->sup, i)) continue;
          float gi = 0.0f;
#pragma unroll
          for (int r = 0; r < EROWS; ++r) gi += B->J[r][i] * B->g[r];
          s -= gi;
        }
        W.rhs[i] = s;
      }
    }
#endif  // HAS_ROWS
    team_sync(tm);
    TICK(15);
    // ---- implicit-damping Euler ----
    for (int i = ln; i < NV; i += TEAM) W.M[i][i] += tb.dof_hdamping[i];
    team_chol_solve<NVP, NVP>(tm, W.M, W.rhs, W.vb, W.dinv);
    for (int i = ln; i < NV; i += TEAM) W.qvel[i] += h * W.vb[i];
    team_sync(tm);
    for (int j = ln; j < NJNT; j += TEAM) {
      const int qadr = tb.jnt_qposadr[j], dadr = tb.jnt_dofadr[j];
      if (tb.jnt_type[j] == JNT_FREE) {
        float* q = W.qpos + qadr;
        for (int a = 0; a < 3; ++a) q[a] += h * W.qvel[dadr + a];
        const float* w = W.qvel + dadr + 3;
        const float angle = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
        const float safe = fmaxf(angle, 1e-12f);
        const float half = 0.5f * angle * h;
        const float sh = sinf(half), ch = cosf(half);
        const float dq[4] = {ch, w[0] / safe * sh, w[1] / safe * sh,
                             w[2] / safe * sh};
        float qn[4];
        quat_mul(q + 3, dq, qn);
        const float norm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] +
                                 qn[2] * qn[2] + qn[3] * qn[3]);
        const float inv = 1.0f / fmaxf(norm, 1e-12f);
        for (int a = 0; a < 4; ++a) q[3 + a] = qn[a] * inv;
      } else {
        W.qpos[qadr] += h * W.qvel[dadr];
      }
    }
  }
  team_sync(tm);
#if PROFILE
  TICK(19);
  if (ln == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < 20; ++i) {
      atomicAdd(&lane_prof[i], prof_acc[i]);
      total += prof_acc[i];
    }
    atomicMax(&lane_prof[25], total);
  }
#endif

  if (MODE == 2) {
    for (int n = ln; n < NTERM; n += TEAM) out0[(size_t)n * K + k] = W.sums[n];
  }
  if (MODE != 0) {
    for (int i = ln; i < NQ; i += TEAM) out1[(size_t)i * K + k] = W.qpos[i];
    for (int i = ln; i < NV; i += TEAM)
      out1[(size_t)(NQ + i) * K + k] = W.qvel[i];
  }
}

// ---------------------------------------------------------- C interface --

extern "C" int lane_tables_size() {
  return (int)(sizeof(TablesHead) + sizeof(ContactTables) + sizeof(TaskConst));
}

extern "C" int lane_team() { return TEAM; }
extern "C" int lane_ctab_in_shared() { return kCtStaged ? 1 : 0; }
// floats of global workspace each candidate needs (rows past the caps)
extern "C" int lane_workspace_floats() { return kWsFloats; }
// dynamic shared memory of a block of `teams` teams
extern "C" int lane_smem_bytes(int teams) {
  return kWorkOff + teams * kWork16;
}

// Stream-ordered upload of the tables from a host buffer that holds the
// generic tables, the contact tables and the task's constant block.
extern "C" int lane_set_tables(const void* src, int nbytes, void* stream) {
  if (nbytes != lane_tables_size()) return -1;
  const char* p = (const char*)src;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      lr_tables, p, sizeof(TablesHead), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  p += sizeof(TablesHead);
  err = cudaMemcpyToSymbolAsync(lr_tables, p, sizeof(ContactTables), kHead16,
                                cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  p += sizeof(ContactTables);
  return (int)cudaMemcpyToSymbolAsync(
      task_tb, p, sizeof(TaskConst), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
}

// Launch on `stream` with `teams` teams a block; `ws` holds
// lane_workspace_floats() floats per candidate. Returns cudaGetLastError()
// (0 = launched).
extern "C" int lane_rollout(const float* qpos0, const float* qvel0,
                            const float* values, const float* aux,
                            const float* table, float* out0, float* out1,
                            float* ws, int K, int teams, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lane_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  if (teams < 1 || teams * TEAM > MAXTHREADS ||
      lane_smem_bytes(teams) > SMEM_MAX)
    return -1;
  const int grid = (K + teams - 1) / teams;
  const int threads = teams * TEAM;
  const int smem = lane_smem_bytes(teams);
  lane_rollout_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      qpos0, qvel0, values, aux, table, out0, out1, ws, K);
  return (int)cudaGetLastError();
}
