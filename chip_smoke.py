#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (built for Hopper, sm_90a) and the CUDA toolkit's
`nvcc`; takes no arguments. It

  1. `device`  — fails unless a CUDA device is present; prints the card's
     name and power limit as `nvidia-smi` gives them;
  2. `build`   — compiles every CUDA kernel of the paths below (the
     rollout kernel in its three output modes, in its feedback mode with
     fluid, in cost-sum mode with fluid, and the humanoid and quadrotor
     builds of phases 7 and 8, the Riccati kernel at every size
     and regularisation checked here, the fused scoring kernel at each
     ported task's cost, the batched Cholesky kernel at each size checked
     here) from ops/csrc/, all `nvcc` processes side by side, and prints
     seconds, registers and spills;
  3. `kernels` — runs each kernel's wrapper on CUDA tensors and holds the
     result against the kernel's plain PyTorch version on the same inputs
     (made from a numpy seed), with the tolerances stated below; on the
     contact-rich inputs of the main path the comparison is step by step,
     beside a control (the plain version against itself, its input
     perturbed in the last bits) measured in the same run; times each
     kernel beside its bound, its plain version and, where one PyTorch call
     computes the same function, that call; the fused scoring kernel also
     at its paths' shapes and layouts (robust's permuted (K, T, nr) batch,
     Cartpole's rows) with its device time and the device kernels one
     scorer call makes (one);
  4. `main_path` — builds the Quadruped Flat task and the predictive
     sampling planner (K=4096 candidates, horizon 36, 3 spline points)
     through the entry points a user calls, runs 1 warm-up + 10 chained
     planner iterations on the card, and checks launches and returns;
  5. `ilqg_path` — builds the Swimmer task and the iLQG planner (horizon
     40, 4 feedback scales, 8 alphas) the same way, runs 1 warm-up + 10
     chained iterations from the same state, and checks the launches of
     the Riccati kernel and of the rollout kernel's feedback mode, the
     returns, and prints the time of each stage; then runs the first 5 of
     those iterations once more, outside the timed and counted window, with both
     kernels held against their plain versions on the very inputs the
     planner hands them (the derivatives' rank-deficient Gauss-Newton
     Hessians, the regularisation as the schedule swings it, the gains the
     backward sweep computed);
  6. the rest of the sampling family, each built through the entry points
     a user calls, 1 warm-up + chained iterations timed with CUDA events,
     the launches of every kernel counted from 0 over the timed iterations,
     the host synchronisations of one more iteration counted (PyTorch's
     sync debug mode), the routes printed and the launches asserted:
     `cem_path` (cross-entropy on Quadruped Flat, K=4096, H=36, lane
     route), `sample_gradient_path` (the same task and size, two rollout
     kernel launches an iteration), `robust_path` (Swimmer at its own
     configuration, K=10, H=201: the clean batch on the rollout kernel,
     the 4 x 4 noisy re-rolls on the pipeline physics with every SPD solve
     on the batched Cholesky kernel and the returns from the fused scoring
     kernel; afterwards one more iteration whose scoring and Cholesky
     inputs are captured and held against the plain versions, and one
     iteration of a second robust planner at a wrench noise the re-rolls
     survive (std 0.05), whose inputs are held the same way over the whole
     horizon),
     `ilqs_path` (Swimmer, lane sampler + iLQG at H=201 with the feedback
     rollouts and the Riccati kernel) and `cartpole_sampling_path` (the lane
     planner's third branch: recorded states, then the fused scoring
     kernel);
  7. the rollout kernel's capsule/box ground contacts, site transmission
     and per-step aux rows: `kernels` cases `humanoid_states_step_by_step`
     (K=512, perturbed poses on the floor, half standing, half lying on
     capsule limbs; each step of the 12-step window with the most active
     capsule-ground rows repeated by the plain version from the kernel's
     state beside the nudged control),
     `humanoid_track_cost_sums`, `humanoid_stand_cost_sums` and
     `quadrotor_cost_sums` (each path's own build at its shape on its own
     inputs, returns against the plain version's, times and bound; Track's
     per-step aux rows) and `quadrotor_site_step_by_step` (site
     transmission, airborne, asymmetric thrusts); then
     `humanoid_track_path` (BASELINE config 4: Humanoid Track, K=512, H=25,
     P=2, 20 chained iterations), `humanoid_stand_path` (K=512, H=25) and
     `quadrotor_path` (its own configuration: K=30, H=61, P=5), each on the
     lane planner with one rollout launch and no host synchronisation an
     iteration;
  8. the rollout kernel's body-body contact pairs: `body_pairs` (each
     build's table bytes, whether its contact tables are staged in shared
     memory, ptxas lines), `kernels` cases `rubik_cost_sums`,
     `cube_solving_cost_sums`, `hand_reorient_cost_sums` (each path's own
     build at its shape, K=512, H=16, on its own inputs, returns against the
     plain version's, times and bound) and
     `{rubik_boxbox,rubik_elliptic,cube_solving,hand_reorient}_states_step_by_step`
     (states builds at K=512, H=3 from perturbed home poses, the hand
     tasks' cubes moved into a fingertip where a random shift finds one
     and their capsule-box rows asserted; Rubik at H=2
     with its path's pairs and its box-box pairs, its knobs enlarged until
     adjacent knobs interpenetrate, and with elliptic cones; every step
     repeated by the plain version beside the nudged control, the recorded
     residual rows' returns against the plain version's rows at the same
     states, the plain rollout's time, the active rows by pair type);
     then `rubik_path` (BASELINE config 5: Rubik, K=512, H=16, P=3, 10
     chained iterations), `cube_solving_path` and `hand_reorient_path` (the
     same K and H) on the lane planner;
  9. prints one JSON line describing every kernel (the rollout kernel by
     build: main path, feedback, humanoid track, humanoid stand, site,
     rubik, cube solving, hand reorient, and the checks-only builds rubik
     box-box and rubik elliptic with `on_path: false`; each rollout build
     with its `layout`: lanes a team, teams a block, shared memory, where
     its contact tables live, workspace, ptxas lines), the card line, and
     `{"ok": true, ...}` as the last line.

Any failure raises, so the process exits non-zero. Nothing here imports
JAX or the JAX package.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12    # HBM bandwidth, H100 SXM data sheet
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores

SEED = 0
K_MAIN, HORIZON, SPLINE_POINTS, EXPLORATION = 4096, 36, 3, 0.04
ITERATIONS = 10
ILQG_HORIZON, ILQG_ITERATIONS = 40, 10
# iterations repeated with both iLQG kernels checked on the planner's own
# inputs (the first 2 of the timed 10: the check costs ~15 s an iteration;
# 5 until the body-pair phase made the script pass 1,000 of its 1,200 s)
ILQG_CHECKED_ITERATIONS = 2

# Tolerances, kernel vs its plain version on the same inputs, both float32
# on the card. The two differ in summation order only, but the rollout is
# not a continuous function of its inputs: the Newton solve runs a fixed,
# small number of iterations over gated rows and cone zones, and a last-bit
# difference that flips a gate changes that step's result by far more than
# rounding. So agreement is stated per share of candidates, never as one
# maximum, and contact-rich rollouts are compared one step at a time from
# the kernel's own states. How often a last-bit difference alone moves a
# step past the tolerance is measured in the same run (the control: the
# plain version against itself with its input state perturbed by 1e-7
# relative), and the kernel's share is held against that reading.
TOL_STATES_CARTPOLE = 2e-4      # abs, every recorded state, 20 steps
TOL_RETURN_REL = 1e-4           # |dR| <= tol * max(1, |R|)
TOL_RETURN_SHARE = 0.01         # share of candidates allowed over it
TOL_ROWS = 5e-4                 # abs/rel, residual rows given the same state
TOL_STEP = 2e-4                 # abs/rel, next state given the same state
TOL_STEP_SHARE = 0.08           # share of (step, candidate) pairs over it
TOL_STEP_VS_CONTROL = 1.5       # ... and at most this many times the control's
TOL_STEP_MEDIAN = 1e-5          # median one-step error
TOL_GROUND_MEDIAN_REL = 0.1     # median |dR|/R over full contact rollouts
TOL_NONFINITE_SHARE = 0.05      # candidates allowed to diverge
CONTROL_PERTURBATION = 1e-7     # relative, on the control's input state
# Riccati kernel vs backward_pass: the two sum in different orders. 1e-4 abs /
# 1e-3 rel (2e-4 abs from ndx 36 up) are the JAX suite's bars for its kernel
# against its scan. The box QP's free set is a discontinuous decision: a
# last-bit difference in a gradient can flip a control between free and
# clamped, which changes k and a row of K at that step and everything the
# sweep computes before it in time. So the bars are held on the steps the
# sweep reaches before the first such flip, the share of (step, control)
# entries whose free/clamped state differs is printed, and at most
# TOL_QP_FLIP_CASES of the cases may contain a flip at all.
TOL_RICCATI_ABS, TOL_RICCATI_ABS_WIDE, TOL_RICCATI_REL = 1e-4, 2e-4, 1e-3
TOL_QP_FLIP_SHARE = 0.02
TOL_QP_FLIP_CASES = 2
# feedback rollouts on Swimmer (no contacts; limit rows stay inactive):
# every recorded state and residual row, absolute
TOL_STATES_SWIMMER = 2e-4
# On the planner's own backward-sweep inputs the problem can be ill
# conditioned (Gauss-Newton Hessians of 7 residual rows have rank <= 7 of 16,
# the regularisation goes down to 1e-6), and then two correct float32 sweeps
# differ by more than the bars above. The arbiter is the plain version in
# float64 on the same inputs: a sweep passes when it is within the bars of
# the float32 plain version, or when its distance from the float64 result is
# at most this many times the float32 plain version's own distance.
TOL_RICCATI_VS_PLAIN32 = 2.0
# fused scoring kernel vs its plain version (the mean over the horizon of
# CostSpec.cost): the JAX suite's bar for its kernel (tests/test_ops.py),
# absolute and relative
TOL_SCORE = 2e-4
# batched Cholesky solve vs its plain version: the JAX suite's bar
TOL_CHOL = 2e-3
CEM_ITERATIONS = SG_ITERATIONS = CARTPOLE_ITERATIONS = 10
# robust: 13-19 s an iteration, host-bound (2, not 5, since the body-pair
# phase)
ROBUST_ITERATIONS, ILQS_ITERATIONS = 2, 5
CHOL_SIZES = ((4, 128), (18, 128), (7, 256), (8, 16), (18, 4096))
# phase 7: Humanoid Track at BASELINE config 4 (scripts/bench_configs.py:245)
K_HUMANOID, HORIZON_HUMANOID = 512, 25
HUMANOID_TRACK_ITERATIONS, HUMANOID_STAND_ITERATIONS = 20, 5
QUADROTOR_ITERATIONS = 10
K_QUADROTOR_CHECK = 256
# one step of the kernel vs its plain version from the same state, absolute
# (the port's CPU tests hold the plain version to the JAX package's step by
# the same bars)
TOL_STEP_QPOS, TOL_STEP_QVEL = 2e-4, 2e-3
# phase 8: body-body pairs. Rubik at BASELINE config 5
# (scripts/bench_configs.py:246: K=512, H=16), Cube Solving (:248) and Hand
# Reorient (:250) at the same K and H, each on its own path build; the
# step-by-step checks, Rubik with its box-box pairs and Rubik with elliptic
# cones on states builds at a small shape
K_BODY, HORIZON_BODY = 512, 16
RUBIK_ITERATIONS, CUBE_SOLVING_ITERATIONS, HAND_REORIENT_ITERATIONS = 10, 5, 5
K_BODY_CHECK, HORIZON_BODY_CHECK = 512, 3
# Rubik's knobs never reach each other as the faces turn, so its box-box
# build enlarges them to cubes of this half-size: the 12 pairs of adjacent
# knobs then interpenetrate by up to ~5 mm, and the faces are turned by
# BOXBOX_FACE_STD (radians) at random
BOXBOX_KNOB_HALF, BOXBOX_FACE_STD = 0.019, 0.2
# the humanoid's states build is checked step by step over a window of its
# steps (all 24 until the body-pair phase made the script pass 1,000 s)
HUMANOID_CHECK_STEPS = 12
BODY_TASKS = {"rubik": "Rubik", "cube_solving": "Cube Solving",
              "hand_reorient": "Hand Reorient"}
# the robust path's on-path checks: at the task's OU wrench noise (std 0.2)
# the shortest sane prefix of the 16 re-rolls over the steps (23 and 24 in
# the CPU reading and a card run); at std 0.05 the re-rolls survive (16 of
# 16 in the CPU reading), all but ROBUST_SANE_SLACK of them are required to
ROBUST_MIN_PREFIX = 10
ROBUST_SANE_XFRC = 0.05
ROBUST_SANE_SLACK = 2


def emit(phase, **kw):
  print(json.dumps(dict(phase=phase, **kw)), flush=True)


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  return out.splitlines()[0]


def time_cuda(fn, reps):
  """Mean milliseconds of fn() over reps launches (CUDA events)."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def count_flops(fn):
  """Floating-point operations fn() executes as PyTorch ops: one per
  output element of every arithmetic op (multiply and add counted
  separately, a transcendental as one)."""
  from torch.utils._python_dispatch import TorchDispatchMode

  skip = ("stack", "cat", "select", "slice", "view", "reshape", "unsqueeze",
          "expand", "clone", "copy", "zeros", "ones", "full", "empty",
          "detach", "alias", "to_copy", "lift", "squeeze", "permute",
          "transpose", "unbind", "index", "repeat", "scalar_tensor")

  class Counter(TorchDispatchMode):
    total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      name = func.__name__
      if not any(s in name for s in skip) and isinstance(out, torch.Tensor) \
          and out.dtype.is_floating_point:
        n = out.numel()
        if name.startswith("sum"):
          n = max(a.numel() for a in args if isinstance(a, torch.Tensor))
        Counter.total += n
      return out

  with Counter():
    fn()
  return Counter.total


def make_quadruped_inputs(task, spec, cost_terms, k, rng, device):
  """Candidates as the planner makes them: the home-pose nominal plus
  exploration noise, clipped to the control range."""
  m = task.plan_model
  d0 = task.make_data()
  lo = m.actuator_ctrlrange[:, 0].cpu().numpy()
  hi = m.actuator_ctrlrange[:, 1].cpu().numpy()
  nominal = np.tile(np.asarray(task.home_qpos[7:], np.float32),
                    (SPLINE_POINTS, 1))
  noise = rng.standard_normal((k, SPLINE_POINTS, m.nu)).astype(np.float32)
  cand = nominal[None] + EXPLORATION * 0.5 * (hi - lo) * noise
  cand[0] = nominal
  cand = np.clip(cand, lo, hi)
  values = torch.as_tensor(
      cand.reshape(k, SPLINE_POINTS * m.nu).T.copy()).to(device)
  aux = spec["make_aux"](d0, task.residual_params)
  if cost_terms:
    aux = torch.cat([aux, task.cost_spec.norm_params[:, :2].reshape(-1)])
  aux = aux[:, None].repeat(1, k).contiguous()
  qpos0 = d0.qpos[:, None].repeat(1, k).contiguous()
  qvel0 = d0.qvel[:, None].repeat(1, k).contiguous()
  return qpos0, qvel0, values, aux


def riccati_problem(horizon, ndx, nu, seed, tight_limits, device):
  """One random backward-sweep problem: near-identity dynamics, SPD cost
  Hessians, control limits loose (5.0) or tight (0.05, so that controls
  sit on their bounds and the free-set inverse is exercised)."""
  rng = np.random.default_rng(seed)
  t = horizon
  w = rng.standard_normal((t, ndx, ndx))
  wu = rng.standard_normal((t, nu, nu))
  lim = 0.05 if tight_limits else 5.0
  arrays = [
      np.eye(ndx) + 0.05 * rng.standard_normal((t - 1, ndx, ndx)),
      0.1 * rng.standard_normal((t - 1, ndx, nu)),
      0.3 * rng.standard_normal((t, ndx)),
      0.3 * rng.standard_normal((t, nu)),
      np.einsum("tij,tkj->tik", w, w) / ndx + 0.5 * np.eye(ndx),
      0.05 * rng.standard_normal((t, ndx, nu)),
      np.einsum("tij,tkj->tik", wu, wu) / nu + 0.5 * np.eye(nu),
      np.full((t - 1, nu), -lim), np.full((t - 1, nu), lim)]
  return [torch.as_tensor(a.astype(np.float32)).to(device) for a in arrays]


def riccati_work(ndx, nu, horizon, qp_iters):
  """(bytes moved once, float32 operations) of one backward sweep, from its
  shapes: every input read once, every output written once; a multiply-add
  counted as two operations."""
  t, n, m = horizon, ndx, nu
  nbytes = 4 * ((t - 1) * (n * n + n * m + 2 * m) + t * (n + m + n * n +
                                                       n * m + m * m) + 1 +
                (t - 1) * (m + m * n) + 3)
  step = (2 * n * n * n + 2 * n * n * m + 2 * n * n + 2 * n * m      # phase 1
          + 2 * n * n * n + 2 * n * n * m + 2 * n * m * m            # phase 2
          + (qp_iters + 1) * (4 * m * m * m + 4 * m * m)             # box QP
          + 2 * m * m * n + 2 * m * m                                # gain
          + 2 * m * m * n + 4 * n * m                                # Quu K
          + 6 * n * n * m + 2 * n * n)                               # Vxx
  return nbytes, (t - 1) * step


def check_riccati(kern, prob, reg, atol, timed=False):
  """One problem through the Riccati kernel and through its plain version
  on the same device; errors on the steps before the first free-set flip."""
  got = kern(*prob, reg)
  want = kern.plain(*prob, reg)
  if prob[0].is_cuda:
    torch.cuda.synchronize()
  (ks, km, dv, ok), (ks_w, km_w, dv_w, ok_w) = got, want
  lo, hi = prob[7], prob[8]

  def clamped(k):
    return (k <= lo) | (k >= hi)

  flips = clamped(ks) != clamped(ks_w)                      # (T-1, nu)
  steps = torch.nonzero(flips.any(dim=1))
  first = int(steps.max()) if len(steps) else -1     # sweep runs T-2 .. 0
  sel = slice(first + 1, None)

  def err(a, b):
    d = (a - b).abs()
    return float(d.max()) if d.numel() else 0.0, \
        bool((d <= atol + TOL_RICCATI_REL * b.abs()).all())

  e_k, ok_k = err(ks[sel], ks_w[sel])
  e_m, ok_m = err(km[sel], km_w[sel])
  out = dict(max_abs_err_k=e_k, max_abs_err_K=e_m, within_tol=ok_k and ok_m,
             flip_share=float(flips.float().mean()), first_flip_step=first,
             clamped_share=float(clamped(ks_w).float().mean()),
             ok=bool(ok), ok_plain=bool(ok_w))
  if first < 0:
    e1, ok1 = err(dv[0], dv_w[0])
    e2, ok2 = err(dv[1], dv_w[1])
    out.update(err_dv1=e1, err_dv2=e2,
               within_tol=out["within_tol"] and ok1 and ok2)
  return out


def check_riccati_on_path(kern, args):
  """check_riccati on the planner's own inputs, with the float64 plain
  version as the arbiter where the float32 results part ways."""
  prob, reg = list(args[:9]), args[9]
  row = check_riccati(kern, prob, reg, TOL_RICCATI_ABS)
  ks, km, _, _ = kern(*prob, reg)
  ks_p, km_p, _, _ = kern.plain(*prob, reg)
  ks_d, km_d, _, _ = kern.plain(*[x.double() for x in prob], reg.double())

  def dist(k, m):
    scale_k = torch.clamp(ks_d.abs(), min=1.0)
    scale_m = torch.clamp(km_d.abs(), min=1.0)
    return max(float(((k - ks_d).abs() / scale_k).max()),
               float(((m - km_d).abs() / scale_m).max()))

  d_kernel, d_plain = dist(ks, km), dist(ks_p, km_p)
  row.update(reg=float(reg), dist_f64_kernel=d_kernel, dist_f64_plain=d_plain,
             max_abs_K=float(km_d.abs().max()))
  row["passes"] = bool(
      (row["within_tol"] and row["first_flip_step"] < 0) or
      d_kernel <= TOL_RICCATI_VS_PLAIN32 * d_plain + TOL_RICCATI_ABS)
  return row


def count_syncs(fn):
  """fn()'s result and the number of synchronising CUDA calls it made, as
  PyTorch's sync debug mode reports them (a read-back to the host, a copy
  from pageable host memory, an explicit synchronise)."""
  import warnings
  torch.cuda.set_sync_debug_mode("warn")
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      out = fn()
  finally:
    torch.cuda.set_sync_debug_mode("default")
  return out, sum("synchroniz" in str(w.message) for w in caught)


def score_work(cost_spec, t_hor, k):
  """(bytes moved once, float32 operations) of one fused scoring launch:
  the residuals, weights and norm parameters read once, the returns written
  once; per row of a step, a square and an add (quadratic, L2) or a
  square, two adds, a square root and a subtraction (smooth-abs); per term
  and step the norm's finish (quadratic 1, L2 4) and the weighted add (2);
  per step the add into the total, per candidate the division."""
  per_step = 1
  for ntype, dim in zip(cost_spec.norm_types, cost_spec.dims):
    per_step += {0: 2 * dim + 3, 2: 2 * dim + 6}.get(int(ntype), 5 * dim + 2)
  nbytes = 4 * (t_hor * cost_spec.num_residual * k + 2 * cost_spec.num_term
                + k)
  return nbytes, k * (t_hor * per_step + 1)


def chol_work(n, k):
  """(bytes moved once, float32 operations) of one batched Cholesky solve:
  the lower triangle of A (n, n, K) and b (n, K) read once, x written once
  (an SPD solve needs no more: the kernel never reads the upper triangle,
  whose entries are rows of K floats of their own); the operations are
  those the plain version executes for one system, times K."""
  from mujoco_mpc_tpu_torch.ops import cholesky
  a1 = torch.eye(n)[..., None] * 2.0
  b1 = torch.ones((n, 1))
  flops = count_flops(lambda: cholesky.chol_solve_lanes_plain(a1, b1))
  return 4 * (n * (n + 1) // 2 + 2 * n) * k, flops * k


def spd_batch(n, k, rng, device):
  """K random SPD systems on the lane layout: A (n, n, K), b (n, K)."""
  g = rng.standard_normal((k, n, n))
  a = np.einsum("kij,klj->kil", g, g) + n * np.eye(n)[None]
  b = rng.standard_normal((n, k))
  return (torch.as_tensor(np.ascontiguousarray(
      np.moveaxis(a, 0, -1)).astype(np.float32)).to(device),
          torch.as_tensor(b.astype(np.float32)).to(device))


def device_ms(fn, reps, kernel):
  """Mean device milliseconds of the launches of `kernel` (a substring of
  the kernel's name) made by `reps` calls of fn(), from torch.profiler (the
  kernel's own time on the card, without the host's time to launch it);
  None where the profiler shows no device time."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  total, count = 0.0, 0
  for ev in prof.key_averages():
    if kernel in ev.key:
      us = getattr(ev, "device_time_total", None)
      total += getattr(ev, "cuda_time_total", 0.0) if us is None else us
      count += ev.count
  return total / 1e3 / count if count and total > 0 else None


def device_kernels(fn, reps=20):
  """{name: launches a call} of the device kernels fn() makes, from
  torch.profiler over `reps` calls after one warm call, read as
  `device_ms` reads it (a profile of one short call has shown no device
  time on the card); empty where the profiler shows no device time."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  out = {}
  for ev in prof.key_averages():
    us = getattr(ev, "device_time_total", None)
    if (getattr(ev, "cuda_time_total", 0.0) if us is None else us) > 0:
      out[ev.key] = ev.count / reps
  return out


def call_ms(fn, reps):
  """Host-clock milliseconds of one call of fn(), not synchronised: what
  the caller waits for before its next call."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  t1 = time.perf_counter()
  torch.cuda.synchronize()
  return (t1 - t0) * 1e3 / reps


def host_ms(fn, reps=3):
  """Host-clock milliseconds of fn() (a plain version, launch-bound), after
  one warm call."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3 / reps


def run_path(planner, d0, iterations, counters, gen=None,
             around_last=contextlib.nullcontext):
  """1 warm-up iteration, then `iterations` chained ones timed with CUDA
  events with every kernel's launch count set to 0 just before and read
  just after; then one more iteration, inside `around_last()`, with its
  synchronising calls counted. Returns (infos, ms per iteration, launches,
  syncs)."""
  planner.optimize(gen, d0)
  torch.cuda.synchronize()
  for mod in counters.values():
    mod.launch_count = 0
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  infos = [planner.optimize(gen, d0) for _ in range(iterations)]
  end.record()
  torch.cuda.synchronize()
  launches = {name: mod.launch_count for name, mod in counters.items()}
  ms = start.elapsed_time(end) / iterations
  with around_last():
    _, syncs = count_syncs(lambda: planner.optimize(gen, d0))
    torch.cuda.synchronize()
  return infos, ms, launches, syncs


def planner_candidates(task, k, p, exploration, rng, device):
  """(P*nu, K) spline values as the lane planner makes them from its
  initial policy (mid-range): the nominal in column 0, exploration noise
  (scaled by half the control range) elsewhere, clipped."""
  m = task.plan_model
  lo = m.actuator_ctrlrange[:, 0].cpu().numpy()
  hi = m.actuator_ctrlrange[:, 1].cpu().numpy()
  nominal = np.tile(0.5 * (lo + hi), (p, 1)).astype(np.float32)
  noise = rng.standard_normal((k, p, m.nu)).astype(np.float32)
  cand = np.clip(nominal[None] + exploration * 0.5 * (hi - lo) * noise,
                 lo, hi)
  cand[0] = nominal
  return torch.as_tensor(cand.reshape(k, p * m.nu).T.copy()).to(device)


def lane_aux(task, spec, d0, k, cost_terms):
  """(naux (+ 2 nterm), K) aux rows as the lane planner tiles them."""
  aux = spec["make_aux"](d0, task.residual_params)
  if cost_terms:
    aux = torch.cat([aux, task.cost_spec.norm_params[:, :2].reshape(-1)])
  return aux[:, None].repeat(1, k).contiguous()


def step_by_step(kern, rec, values, aux, p, nq, nv, gen, window=None,
                 first=None):
  """Each step of a recorded rollout but the last (whose outcome the record
  does not hold; only the steps of `window` = range(start, stop), if given)
  repeated by the plain version from the kernel's own pre-step state, and
  once more from that state nudged by CONTROL_PERTURBATION (relative): per
  (step, candidate) pair, whether the next state is within TOL_STEP_QPOS /
  TOL_STEP_QVEL (absolute), for the kernel and for the control; pairs of
  rollouts that have blown up are left out. `first`, if given, is the plain
  version's state after step 0 from the same initial state (a plain rollout
  of the same inputs), taken in place of repeating that step."""
  horizon, _, k = rec.shape
  nu = values.shape[0] // p

  def nudged(x):
    return x * (1.0 + CONTROL_PERTURBATION * torch.randn(
        x.shape, generator=gen, device=x.device))

  def within(a, b):
    return ((a[:nq] - b[:nq]).abs().amax(dim=0) <= TOL_STEP_QPOS) & \
        ((a[nq:] - b[nq:]).abs().amax(dim=0) <= TOL_STEP_QVEL)

  ok_k, ok_c, sane, err_q, err_v = [], [], [], [], []
  for t in window or range(horizon - 1):
    node = min(int(t * p / max(horizon - 1, 1)), p - 1)
    ctrl = values[node * nu:(node + 1) * nu]
    qp, qv = rec[t, :nq], rec[t, nq:nq + nv]
    want = first if t == 0 and first is not None else \
        torch.cat(kern.step_array(qp, qv, ctrl, t, aux)[:2])
    ctl = torch.cat(kern.step_array(nudged(qp), nudged(qv), ctrl, t,
                                    aux)[:2])
    after = rec[t + 1, :nq + nv]
    ok_k.append(within(after, want))
    ok_c.append(within(ctl, want))
    err_q.append((after[:nq] - want[:nq]).abs().amax(dim=0))
    err_v.append((after[nq:] - want[nq:]).abs().amax(dim=0))
    sane.append(torch.isfinite(want).all(dim=0) &
                (qp.abs().amax(dim=0) < 10.0) & (qv.abs().amax(dim=0) < 100.0))
  sane = torch.stack(sane)
  ok_k, ok_c = torch.stack(ok_k)[sane], torch.stack(ok_c)[sane]
  n = int(sane.sum())
  share_k, share_c = float(ok_k.float().mean()), float(ok_c.float().mean())
  # the kernel's share within the tolerances is held to the control's,
  # less three standard errors of the control's share (sampling noise)
  slack = 3.0 * float(np.sqrt(max(share_c * (1.0 - share_c), 1e-12) / n))
  return dict(pairs=n, left_out_pairs=int((~sane).sum()),
              share_within=share_k, control_share_within=share_c,
              slack=slack, passes=share_k >= share_c - slack,
              median_err_qpos=float(torch.stack(err_q)[sane].median()),
              median_err_qvel=float(torch.stack(err_v)[sane].median()),
              max_err_qpos=float(torch.stack(err_q)[sane].max()),
              max_err_qvel=float(torch.stack(err_v)[sane].max()))


def active_rows(m, gaps):
  """Rows of the contact points of `gaps` (step_lane.contact_gaps) whose
  gap is negative, summed over the candidates, by pair type
  ("plane-capsule", "capsule-box", ...): one for condim 1, else 2 (condim
  - 1) pyramidal or condim in an elliptic cone block."""
  from mujoco_mpc_tpu_torch.physics.model import (GEOM_BOX, GEOM_CAPSULE,
                                                  GEOM_PLANE, GEOM_SPHERE)

  names = {GEOM_PLANE: "plane", GEOM_SPHERE: "sphere",
           GEOM_CAPSULE: "capsule", GEOM_BOX: "box"}
  elliptic = int(m.opt.cone) == 1
  out = {}
  for types, condim, gap in gaps:
    per = 1 if condim == 1 else condim if elliptic else 2 * (condim - 1)
    key = "-".join(names[t] for t in types)
    out[key] = out.get(key, 0) + per * int((gap < 0).sum())
  return out


def kernel_bound(kern, args, outs, steps, k):
  """(bytes each moved once, float32 operations, bytes ms, operations ms)
  of one rollout launch: the operations the plain version executes for one
  step of one candidate (on the CPU; every row is evaluated whatever its
  gate), times the steps and the candidates."""
  nbytes = 4 * sum(int(a.numel()) for a in (*args, *outs))
  q, v, values, aux = [a[:, :1].cpu() for a in args]
  nu = kern.build_defines()["LR_NU"]
  flops = count_flops(lambda: kern.step_array(q, v, values[:nu], 0, aux)) \
      * steps * k
  return nbytes, flops, nbytes / H100_BYTES_PER_S * 1e3, \
      flops / H100_F32_FLOPS * 1e3


def cost_sums_check(kern, task, spec, d0, values, horizon):
  """One cost-sum launch of `kern` from d0's state on every candidate of
  `values`, held against the plain version on the same inputs: the returns
  (weighted term sums over the horizon) within TOL_RETURN_REL but for a
  TOL_RETURN_SHARE of candidates, and the best candidate of each (0 is the
  nominal); the kernel's time (CUDA events), the plain version's (one call,
  host clock) and the bound. Returns the row to print, which also keys the
  build's summary entry."""
  k = values.shape[1]
  terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
  args = (d0.qpos[:, None].repeat(1, k).contiguous(),
          d0.qvel[:, None].repeat(1, k).contiguous(), values,
          lane_aux(task, spec, d0, k, terms))
  sums, fin = kern(*args)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  sums_p, _ = kern.plain(*args)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t0) * 1e3
  w = task.cost_spec.weights[:, None]
  ret = (w * sums).sum(dim=0) / horizon
  ret_p = (w * sums_p).sum(dim=0) / horizon
  ok = torch.isfinite(ret) & torch.isfinite(ret_p)
  rel = ((ret - ret_p).abs() / torch.clamp(ret_p.abs(), min=1.0))[ok]
  nb, nf, bytes_ms, ops_ms = kernel_bound(kern, args, (sums, fin), horizon, k)
  row = dict(K=k, H=horizon, naux=spec["naux"],
             max_abs_err_return=float((ret - ret_p).abs()[ok].max()),
             median_rel=float(rel.median()), max_rel=float(rel.max()),
             share_over_tol=float((rel > TOL_RETURN_REL).float().mean()),
             tol_return_rel=TOL_RETURN_REL, tol_share=TOL_RETURN_SHARE,
             nonfinite=int((~ok).sum()), argmin=int(ret.argmin()),
             argmin_plain=int(ret_p.argmin()),
             kernel_ms=time_cuda(lambda: kern(*args), 10), plain_ms=plain_ms,
             bytes=nb, flops=nf, bytes_ms=bytes_ms, ops_ms=ops_ms)
  assert row["nonfinite"] <= TOL_NONFINITE_SHARE * k, row
  assert row["share_over_tol"] <= TOL_RETURN_SHARE, row
  return row


def lane_path(task, cfg, iterations, name, counters, card, device):
  """The lane planner through the entry points a user calls: `iterations`
  chained iterations (run_path), one rollout launch and no host
  synchronisation an iteration, the best never worse than the nominal and
  the nominal non-increasing. Returns the rollout kernel's launches."""
  from mujoco_mpc_tpu_torch.ops import sampling_lane

  planner = sampling_lane.LaneSamplingPlanner(task, cfg, device=device)
  assert planner.routes == dict(rollouts="rollout_kernel",
                                scoring="rollout_kernel"), planner.routes
  infos, ms, launches, syncs = run_path(
      planner, task.make_data(), iterations, counters,
      torch.Generator(device=device).manual_seed(SEED))
  nominal = [float(i["nominal_return"]) for i in infos]
  best = [float(i["best_return"]) for i in infos]
  emit(name, task=task.name, K=cfg.num_trajectory, H=cfg.horizon,
       P=cfg.num_spline_points, exploration=cfg.exploration[0],
       timestep=float(task.plan_model.opt.timestep),
       iterations=iterations, ms_per_iteration=ms,
       rollouts_per_s=cfg.num_trajectory / (ms * 1e-3), launches=launches,
       host_syncs_per_iteration=syncs, routes=planner.routes,
       best_return=best, nominal_return=nominal,
       poisoned_per_iteration=[int((i["returns"] >= 1e6).sum())
                               for i in infos], card=card)
  assert launches == dict(rollout=iterations, riccati=0, scoring=0,
                          cholesky=0), launches
  assert syncs == 0, syncs
  for i in range(iterations):
    assert np.isfinite(nominal[i]) and best[i] <= nominal[i], \
        (i, best[i], nominal[i])
    assert i == 0 or nominal[i] <= nominal[i - 1], (i, nominal)
  assert best[-1] < 1e6, best
  return launches["rollout"]


def b1_layout(kern, k):
  """A rollout build's launch at K=k: lanes a team, teams a block, dynamic
  shared memory a block, whether its contact tables are staged in shared
  memory (else read from global memory through __ldg), global workspace a
  candidate (active rows past the shared-memory caps), and ptxas's
  registers, stack and spill lines."""
  from mujoco_mpc_tpu_torch.ops import _build, step_lane

  lib = kern.library()
  team = lib.lane_team()
  tpb = step_lane.teams_per_block(
      k, team, lib.lane_smem_bytes,
      torch.cuda.get_device_properties(0).multi_processor_count)
  path = _build.library_path("lane_rollout.cu", kern.build_defines())[0]
  return dict(team=team, teams_per_block=tpb,
              smem_bytes_per_block=lib.lane_smem_bytes(tpb),
              tables_in_shared=bool(lib.lane_ctab_in_shared()),
              workspace_floats_per_candidate=lib.lane_workspace_floats(),
              ptxas=_build.BUILD_LOG.get(path, {}).get("ptxas"))


def rollout_entry(name, row, path, launches, **extra):
  """The summary entry of one rollout-kernel build held to its plain
  version by `cost_sums_check` (or `body_states_check`)."""
  return dict(
      name=f"step_lane.rollout[{name}]", route="cuda",
      source="mujoco_mpc_tpu_torch/ops/csrc/lane_rollout.cu",
      replaces="mujoco_mpc_tpu/ops/step_lane.py:184",
      launches=launches.get(path, 0),
      launches_by_path={path: launches[path]} if path in launches else {},
      max_abs_err=row["max_abs_err_return"], ms=row["kernel_ms"],
      plain_ms=row["plain_ms"],
      bound_ms=max(row["bytes_ms"], row["ops_ms"]),
      bound_by="bytes" if row["bytes_ms"] >= row["ops_ms"]
      else "operations", library_ms=None, **extra)


def ground_site_aux_builds(device):
  """Phase 7's tasks and rollout-kernel builds: Humanoid Track (cost sums,
  per-step aux rows), Humanoid Stand (cost sums), the humanoid in states
  mode (the step-by-step check), the quadrotor (site transmission) at its
  own configuration in cost-sum and states mode; the planners of phase 7
  find them built."""
  from mujoco_mpc_tpu_torch.ops import step_lane
  from mujoco_mpc_tpu_torch.planners import sampling
  from mujoco_mpc_tpu_torch.tasks import registry

  tasks = {name: registry.get_task(name, device=device)
           for name in ("Humanoid Track", "Humanoid Stand", "Quadrotor")}
  track, stand, rotor = tasks.values()
  t_spec = track.lane_residual_spec(horizon=HORIZON_HUMANOID)
  s_spec = stand.lane_residual_spec()
  r_spec = rotor.lane_residual_spec()
  r_cfg = sampling.make_config(rotor)
  kernels = {}
  for name, task, spec, hor, p, states in (
      ("humanoid_track_cost_sums", track, t_spec, HORIZON_HUMANOID, 2, False),
      ("humanoid_stand_cost_sums", stand, s_spec, HORIZON_HUMANOID, 2, False),
      ("humanoid_states", track, t_spec, HORIZON_HUMANOID, 2, True),
      ("quadrotor_cost_sums", rotor, r_spec, r_cfg.horizon,
       r_cfg.num_spline_points, False),
      ("quadrotor_states", rotor, r_spec, r_cfg.horizon,
       r_cfg.num_spline_points, True)):
    terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
    kernels[name] = step_lane.build_rollout_kernel(
        task.plan_model, hor, p, residual=spec, naux=spec["naux"],
        record_states=states, cost_terms=None if states else terms)
  return tasks, kernels


def ground_site_aux(tasks, kernels, counters, card, device):
  """Phase 7: the rollout kernel's capsule/box ground contacts, site
  transmission and per-step aux rows, then the three paths that need them.
  Returns the summary entries of the paths' three cost-sum builds."""
  from mujoco_mpc_tpu_torch.ops import step_lane
  from mujoco_mpc_tpu_torch.planners import sampling

  rng = np.random.default_rng(SEED + 4)
  gen = torch.Generator(device=device).manual_seed(SEED + 4)
  track, stand, quad = tasks.values()
  hm = track.plan_model
  nq, nv = hm.nq, hm.nv
  h_cfg = dataclasses.replace(sampling.make_config(track),
                              num_trajectory=K_HUMANOID,
                              horizon=HORIZON_HUMANOID)
  p_h, expl_h = h_cfg.num_spline_points, h_cfg.exploration[0]
  assert (nq, nv, hm.nu, p_h, expl_h) == (28, 27, 21, 2, 0.08)
  t_spec = track.lane_residual_spec(horizon=HORIZON_HUMANOID)
  defs = kernels["humanoid_track_cost_sums"].build_defines()
  assert (defs["LR_NCON"], defs["LR_NPROW"], defs["LR_NSUP"],
          defs["LR_NAUX"], defs["LR_NAUXS"]) == (
              39, 156, 15, 36 * HORIZON_HUMANOID, 0), defs
  d0 = track.make_data()
  values = planner_candidates(track, K_HUMANOID, p_h, expl_h, rng, device)

  # (l) humanoid, recorded states, step by step: perturbed poses lowered
  # onto the floor (the lowest contact point 1 mm in, more or less with the
  # joint noise), half of them standing on their box feet, half lying on
  # their backs on capsule limbs; the window of HUMANOID_CHECK_STEPS steps
  # with the most active capsule-ground rows is checked
  kern = kernels["humanoid_states"]
  half = K_HUMANOID // 2
  poses = []
  for quat in ((1.0, 0.0, 0.0, 0.0), (np.sqrt(0.5), 0.0, np.sqrt(0.5), 0.0)):
    pose = d0.qpos.clone()
    pose[3:7] = torch.tensor(quat, device=device)
    pose[2] -= step_lane.contact_clearance(hm, pose) + 0.001
    poses.append(pose[:, None].repeat(1, half))
  qpos0 = torch.cat(poses, dim=1)
  qpos0[7:] += torch.as_tensor(0.01 * rng.standard_normal(
      (hm.nu, K_HUMANOID)).astype(np.float32)).to(device)
  qpos0[2] += torch.as_tensor(rng.uniform(-0.002, 0.002, K_HUMANOID).astype(
      np.float32)).to(device)
  qvel0 = torch.as_tensor(0.1 * rng.standard_normal(
      (nv, K_HUMANOID)).astype(np.float32)).to(device)
  qpos0, qvel0 = qpos0.contiguous(), qvel0.contiguous()
  aux = lane_aux(track, t_spec, d0, K_HUMANOID, None)
  rec = kern(qpos0, qvel0, values, aux)
  torch.cuda.synchronize()
  assert rec.shape == (HORIZON_HUMANOID, nq + nv + t_spec["dim"], K_HUMANOID)
  rows = [active_rows(hm, step_lane.contact_gaps(hm, rec[t, :nq]))
          for t in range(HORIZON_HUMANOID - 1)]
  capsule = [r.get("plane-capsule", 0) for r in rows]
  start = max(range(HORIZON_HUMANOID - HUMANOID_CHECK_STEPS),
              key=lambda s_: sum(capsule[s_:s_ + HUMANOID_CHECK_STEPS]))
  window = range(start, start + HUMANOID_CHECK_STEPS)
  row = step_by_step(kern, rec, values, aux, p_h, nq, nv, gen, window)
  emit("kernels", case="humanoid_states_step_by_step", K=K_HUMANOID,
       H=HORIZON_HUMANOID, steps_checked=[window.start, window.stop],
       active_rows={key: sum(rows[t].get(key, 0) for t in window)
                    for key in rows[0]},
       torso_z_min=float(rec[window.start:window.stop + 1, 2].min()),
       tol_qpos=TOL_STEP_QPOS, tol_qvel=TOL_STEP_QVEL, **row)
  assert sum(capsule[t] for t in window) > 0, capsule
  assert row["left_out_pairs"] <= TOL_NONFINITE_SHARE * rec[:, 0].numel()
  assert row["passes"], row

  # (m) the three paths' own cost-sum builds at their shapes, on their own
  # inputs (home pose, the initial policy plus exploration): Humanoid Track
  # with its per-step aux rows read through aux_at, Humanoid Stand with its
  # aux rows in registers, the quadrotor at its own configuration
  s_cfg = dataclasses.replace(sampling.make_config(stand),
                              num_trajectory=K_HUMANOID,
                              horizon=HORIZON_HUMANOID)
  q_cfg = sampling.make_config(quad)
  assert (q_cfg.num_trajectory, q_cfg.horizon, q_cfg.num_spline_points,
          q_cfg.exploration[0]) == (30, 61, 5, 0.1)
  q_spec = quad.lane_residual_spec()
  checked = {}
  for name, task, spec, cfg in (
      ("humanoid_track", track, t_spec, h_cfg),
      ("humanoid_stand", stand, stand.lane_residual_spec(), s_cfg),
      ("quadrotor", quad, q_spec, q_cfg)):
    vals = values if task is track else planner_candidates(
        task, cfg.num_trajectory, cfg.num_spline_points, cfg.exploration[0],
        rng, device)
    checked[name] = cost_sums_check(kernels[f"{name}_cost_sums"], task, spec,
                                    task.make_data(), vals, cfg.horizon)
    emit("kernels", case=f"{name}_cost_sums", card=card, **checked[name])

  # (n) quadrotor, site transmission, recorded states at its own
  # configuration: airborne (4 m up, tilted: a tumbling quadrotor falls
  # at most ~2 m in the horizon's 0.6 s), asymmetric thrusts; every step
  # from the kernel's own state
  qm = quad.plan_model
  kern = kernels["quadrotor_states"]
  assert kern.build_defines()["LR_SITE"] == 1
  qd0 = quad.make_data()
  qp0 = qd0.qpos[:, None].repeat(1, K_QUADROTOR_CHECK).clone()
  qp0[2] += 3.7
  qp0[3:7] += torch.as_tensor(0.1 * rng.standard_normal(
      (4, K_QUADROTOR_CHECK)).astype(np.float32)).to(device)
  qp0[3:7] /= qp0[3:7].norm(dim=0, keepdim=True)
  qv0 = torch.as_tensor(0.3 * rng.standard_normal(
      (qm.nv, K_QUADROTOR_CHECK)).astype(np.float32)).to(device)
  q_vals = torch.as_tensor(rng.uniform(
      0.5, 2.5, (q_cfg.num_spline_points * qm.nu, K_QUADROTOR_CHECK)).astype(
          np.float32)).to(device)
  q_aux = lane_aux(quad, q_spec, qd0, K_QUADROTOR_CHECK, None)
  q_args = (qp0.contiguous(), qv0.contiguous(), q_vals, q_aux)
  rec = kern(*q_args)
  rec_p = kern.plain(*q_args)
  torch.cuda.synchronize()
  q_row = step_by_step(kern, rec, q_vals, q_aux, q_cfg.num_spline_points,
                       qm.nq, qm.nv, gen)
  emit("kernels", case="quadrotor_site_step_by_step", K=K_QUADROTOR_CHECK,
       H=q_cfg.horizon, z_min=float(rec[:, 2].min()),
       max_abs_err_full_rollout=float((rec - rec_p).abs().max()),
       tol_qpos=TOL_STEP_QPOS, tol_qvel=TOL_STEP_QVEL, **q_row)
  # airborne and contact-free: the steps are smooth, so nearly every one is
  # within the tolerances (as the quadruped's in flight)
  assert float(rec[:, 2].min()) > 0.1 and q_row["left_out_pairs"] == 0
  assert q_row["share_within"] >= 1.0 - TOL_RETURN_SHARE, q_row

  launches = {}
  for task, cfg, iterations, path in (
      (track, h_cfg, HUMANOID_TRACK_ITERATIONS, "humanoid_track_path"),
      (stand, s_cfg, HUMANOID_STAND_ITERATIONS, "humanoid_stand_path"),
      (quad, q_cfg, QUADROTOR_ITERATIONS, "quadrotor_path")):
    launches[path] = lane_path(task, cfg, iterations, path, counters, card,
                               device)

  # the quadrotor's build carries the site transmission
  def layout(name):
    return b1_layout(kernels[f"{name}_cost_sums"], checked[name]["K"])

  return [rollout_entry("humanoid_track", checked["humanoid_track"],
                        "humanoid_track_path", launches,
                        layout=layout("humanoid_track")),
          rollout_entry("humanoid_stand", checked["humanoid_stand"],
                        "humanoid_stand_path", launches,
                        layout=layout("humanoid_stand")),
          dict(rollout_entry("quadrotor", checked["quadrotor"],
                             "quadrotor_path", launches,
                             layout=layout("quadrotor")),
               name="step_lane.rollout[site]")]


def body_config(task):
  """The task's sampling configuration at K_BODY, HORIZON_BODY (as the JAX
  package's bench replaces them)."""
  from mujoco_mpc_tpu_torch.planners import sampling

  return dataclasses.replace(sampling.make_config(task),
                             num_trajectory=K_BODY, horizon=HORIZON_BODY)


def body_pair_builds(device):
  """Phase 8's tasks and rollout-kernel builds: each hand task's path build
  (cost sums at K_BODY, HORIZON_BODY; the planners find them built) and a
  states build (HORIZON_BODY_CHECK); for Rubik, two states builds of two
  steps in its place: with every body pair type (its path's and the 15
  box-box knob pairs, 240 more corner points) on the model with enlarged
  knobs (BOXBOX_KNOB_HALF), and with elliptic cones (condim 3 blocks at
  impratio 10). `models` maps each states build to (task, model, the
  build's contact selection)."""
  from mujoco_mpc_tpu_torch.ops import step_lane
  from mujoco_mpc_tpu_torch.tasks import registry

  tasks = {key: registry.get_task(name, device=device)
           for key, name in BODY_TASKS.items()}
  kernels, models = {}, {}
  for key, task in tasks.items():
    spec = task.lane_residual_spec()
    p = body_config(task).num_spline_points
    select = dict(contact_geoms=getattr(task, "plan_contact_geoms", None),
                  body_pairs=True,
                  body_pair_types=getattr(task, "plan_body_pair_types", None))
    terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
    m = task.plan_model
    kernels[f"{key}_cost_sums"] = step_lane.build_rollout_kernel(
        m, HORIZON_BODY, p, residual=spec, naux=spec["naux"],
        record_states=False, cost_terms=terms, **select)
    variants = [(key, m, select, HORIZON_BODY_CHECK)]
    if key == "rubik":
      knobs = [i for i, n in enumerate(m.names["geom"])
               if n.startswith("knob_")]
      size = m.geom_size.clone()
      size[knobs] = BOXBOX_KNOB_HALF
      elliptic = m.replace(opt=m.opt.replace(
          cone=1, impratio=torch.tensor(10.0, device=device)))
      variants = [("rubik_boxbox", m.replace(geom_size=size),
                   dict(select, body_pair_types=None), 2),
                  ("rubik_elliptic", elliptic, select, 2)]
    for name, model, select_, horizon in variants:
      models[name] = (task, model, select_)
      kernels[f"{name}_states"] = step_lane.build_rollout_kernel(
          model, horizon, p, residual=spec, naux=spec["naux"],
          record_states=True, **select_)
  return tasks, kernels, models


def touch_cube(m, select, qpos0, nhand, rng, device, trials=64):
  """qpos0 with each candidate's cube moved by the first of `trials` random
  translations (up to 6 cm a side) that puts a fingertip capsule into it
  (the deepest capsule-box gap between -3 and -0.5 mm), where one does;
  and the number of candidates moved."""
  from mujoco_mpc_tpu_torch.ops import step_lane
  from mujoco_mpc_tpu_torch.physics.model import GEOM_BOX, GEOM_CAPSULE

  k = qpos0.shape[1]
  shifts = torch.as_tensor(rng.uniform(-0.06, 0.06, (trials, 3)).astype(
      np.float32)).to(device)
  q = qpos0[:, None, :].repeat(1, trials, 1)
  q[nhand:nhand + 3] += shifts.T[:, :, None]
  gaps = step_lane.contact_gaps(m, q.reshape(m.nq, -1), **select)
  deepest = torch.stack([g for types, _, g in gaps
                         if tuple(types) == (GEOM_CAPSULE, GEOM_BOX)]).amin(
                             dim=0).reshape(trials, k)
  ok = (deepest <= -0.0005) & (deepest >= -0.003)
  first = torch.argmax(ok.int(), dim=0)
  found = ok.any(dim=0)
  out = qpos0.clone()
  out[nhand:nhand + 3] += torch.where(found[None], shifts[first].T,
                                      torch.zeros_like(shifts[first].T))
  return out.contiguous(), int(found.sum())


def body_states_check(kern, task, m, select, face_std, rng, gen, device,
                      touch=False):
  """One recorded rollout of a states build from perturbed home poses (the
  hand joints by 0.05 rad, the cube by 2 mm, the faces by `face_std` rad,
  random velocities; with `touch`, the cube moved into a fingertip where
  `touch_cube` finds a way) held to its plain version: every step repeated
  from the kernel's own state beside the nudged control (step_by_step; the
  first step's from the plain version's rollout of the same inputs, which
  is also timed), and the returns of the recorded residual rows (the
  task's cost, mean over the horizon) against those of the plain version's
  rows at the same recorded states, controls and aux rows (teacher-forced:
  the free-running returns of contact-rich rollouts part at gate flips,
  which step_by_step measures). Returns the row to print, with the active
  contact rows of the checked steps by pair type."""
  from mujoco_mpc_tpu_torch.ops import step_lane

  spec = task.lane_residual_spec()
  p = body_config(task).num_spline_points
  k, nq, nv, nu = K_BODY_CHECK, m.nq, m.nv, m.nu
  d0 = task.make_data()
  qpos0 = d0.qpos[:, None].repeat(1, k).clone()
  nhand = task._nhand
  qpos0[:nhand] += torch.as_tensor(0.05 * rng.standard_normal(
      (nhand, k)).astype(np.float32)).to(device)
  qpos0[nhand:nhand + 3] += torch.as_tensor(0.002 * rng.standard_normal(
      (3, k)).astype(np.float32)).to(device)
  if face_std:
    qpos0[nhand + 7:] += torch.as_tensor(face_std * rng.standard_normal(
        (nq - nhand - 7, k)).astype(np.float32)).to(device)
  touching = 0
  if touch:
    qpos0, touching = touch_cube(m, select, qpos0, nhand, rng, device)
  qvel0 = torch.as_tensor(0.05 * rng.standard_normal((nv, k)).astype(
      np.float32)).to(device)
  values = planner_candidates(task, k, p, body_config(task).exploration[0],
                              rng, device)
  aux = lane_aux(task, spec, d0, k, None)
  args = (qpos0.contiguous(), qvel0.contiguous(), values, aux)
  rec = kern(*args)
  torch.cuda.synchronize()
  horizon = rec.shape[0]
  assert torch.equal(rec[0, :nq + nv], torch.cat(args[:2]))
  t0 = time.perf_counter()
  rec_p = kern.plain(*args)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  rows_p = []
  for t in range(horizon):
    node = min(int(t * p / max(horizon - 1, 1)), p - 1)
    rows_p.append(kern.residual_array(rec[t, :nq], rec[t, nq:nq + nv],
                                      values[node * nu:(node + 1) * nu], t,
                                      aux))
  torch.cuda.synchronize()
  rows_ms = (time.perf_counter() - t0) * 1e3
  cs = task.cost_spec
  ret = cs.cost(rec[:, nq + nv:].movedim(1, -1)).mean(dim=0)
  ret_p = cs.cost(torch.stack(rows_p).movedim(1, -1)).mean(dim=0)
  ok = torch.isfinite(ret) & torch.isfinite(ret_p)
  rel = ((ret - ret_p).abs() / torch.clamp(ret_p.abs(), min=1.0))[ok]
  steps = step_by_step(kern, rec, values, aux, p, nq, nv, gen,
                       first=rec_p[1, :nq + nv])
  rows = {}
  for t in range(horizon - 1):
    for key, n in active_rows(m, step_lane.contact_gaps(
        m, rec[t, :nq], **select)).items():
      rows[key] = rows.get(key, 0) + n
  nb, nf, bytes_ms, ops_ms = kernel_bound(kern, args, (rec,), horizon, k)
  row = dict(K=k, H=horizon,
             max_abs_err_return=float((ret - ret_p).abs()[ok].max()),
             median_rel=float(rel.median()), max_rel=float(rel.max()),
             share_over_tol=float((rel > TOL_RETURN_REL).float().mean()),
             tol_return_rel=TOL_RETURN_REL, tol_share=TOL_RETURN_SHARE,
             nonfinite=int((~ok).sum()), residual_rows_plain_ms=rows_ms,
             kernel_ms=time_cuda(lambda: kern(*args), 5), plain_ms=plain_ms,
             bytes=nb, flops=nf, bytes_ms=bytes_ms, ops_ms=ops_ms,
             active_rows=rows, touching_candidates=touching,
             tol_qpos=TOL_STEP_QPOS, tol_qvel=TOL_STEP_QVEL, **steps)
  assert row["nonfinite"] <= TOL_NONFINITE_SHARE * k, row
  assert row["share_over_tol"] <= TOL_RETURN_SHARE, row
  assert steps["left_out_pairs"] <= TOL_NONFINITE_SHARE * steps["pairs"], row
  assert steps["passes"], row
  return row


def body_pairs(tasks, kernels, models, counters, card, device):
  """Phase 8: body-body contact pairs. Each hand task's path build held to
  its plain version at the path's shape, the states builds step by step
  (Rubik also with its box-box pairs and with elliptic cones), then the
  three paths on the lane planner. Returns the summary entries."""
  from mujoco_mpc_tpu_torch.ops import _build

  rng = np.random.default_rng(SEED + 5)
  gen = torch.Generator(device=device).manual_seed(SEED + 5)
  rubik = tasks["rubik"]
  rm = rubik.plan_model
  cfg = body_config(rubik)
  assert (rm.nq, rm.nv, rm.nu, cfg.num_spline_points, cfg.exploration[0],
          float(rm.opt.timestep)) == (22, 21, 9, 3, 0.15,
                                      float(np.float32(0.01)))
  defs = {name: k.build_defines() for name, k in kernels.items()}
  # the plan model's 74 ground points (9 capsules, 7 boxes) and 156 body
  # points (30 capsule-capsule, 63 capsule-box pairs); 240 more corner
  # points with the box-box knob pairs
  assert (defs["rubik_cost_sums"]["LR_NCON"],
          defs["rubik_cost_sums"]["LR_NBCON"]) == (74, 156)
  assert defs["rubik_boxbox_states"]["LR_NBCON"] == 156 + 240
  assert defs["rubik_elliptic_states"]["LR_NECON"] == 230
  ptxas = {name: _build.BUILD_LOG[_build.library_path(
      "lane_rollout.cu", d)[0]]["ptxas"] for name, d in defs.items()}
  tables = {name: dict(bytes=len(kernels[name].tables()),
                       in_shared_memory=bool(
                           kernels[name].library().lane_ctab_in_shared()),
                       ncon=d["LR_NCON"], nbcon=d["LR_NBCON"],
                       nprow=d["LR_NPROW"], necon=d["LR_NECON"],
                       nsup=d["LR_NSUP"])
            for name, d in defs.items()}
  emit("body_pairs", case="builds", tables=tables, ptxas=ptxas)

  # (o) each path's own build at its shape, on its own inputs
  checked = {}
  for key, task in tasks.items():
    c_ = body_config(task)
    vals = planner_candidates(task, K_BODY, c_.num_spline_points,
                              c_.exploration[0], rng, device)
    checked[key] = cost_sums_check(kernels[f"{key}_cost_sums"], task,
                                   task.lane_residual_spec(),
                                   task.make_data(), vals, HORIZON_BODY)
    emit("kernels", case=f"{key}_cost_sums", card=card,
         all_within_tol=checked[key]["share_over_tol"] == 0.0,
         **checked[key])

  # (p) the states builds: step by step and returns at a small shape
  states = {}
  for name, (task, m, select) in models.items():
    states[name] = body_states_check(
        kernels[f"{name}_states"], task, m, select,
        BOXBOX_FACE_STD if name == "rubik_boxbox" else 0.0, rng, gen, device,
        touch=name in ("cube_solving", "hand_reorient"))
    emit("kernels", case=f"{name}_states_step_by_step", card=card,
         **states[name])
  # the box-box branch is held with rows in the solve, and the hand tasks'
  # fingertip-cube (capsule-box) branch too
  assert states["rubik_boxbox"]["active_rows"].get("box-box", 0) > 0, \
      states["rubik_boxbox"]["active_rows"]
  for name in ("cube_solving", "hand_reorient"):
    assert states[name]["active_rows"].get("capsule-box", 0) > 0, \
        (name, states[name]["active_rows"])

  # (q) the paths
  launches = {}
  for key, iterations in (("rubik", RUBIK_ITERATIONS),
                          ("cube_solving", CUBE_SOLVING_ITERATIONS),
                          ("hand_reorient", HAND_REORIENT_ITERATIONS)):
    task = tasks[key]
    launches[f"{key}_path"] = lane_path(task, body_config(task), iterations,
                                        f"{key}_path", counters, card,
                                        device)

  def extra(name):
    k = K_BODY if name.endswith("_cost_sums") else K_BODY_CHECK
    return dict(ptxas=ptxas[name], tables=tables[name],
                layout=b1_layout(kernels[name], k))

  entries = [rollout_entry(key, checked[key], f"{key}_path", launches,
                           shape=dict(K=K_BODY, H=HORIZON_BODY),
                           **extra(f"{key}_cost_sums"))
             for key in tasks]
  # the checks-only builds (launched by no path)
  entries += [rollout_entry(
      name, states[name], None, launches, on_path=False,
      shape=dict(K=states[name]["K"], H=states[name]["H"]),
      **extra(f"{name}_states")) for name in ("rubik_boxbox",
                                              "rubik_elliptic")]
  return entries


def main():
  # ---- 1. device ----
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    return 1
  device = torch.device("cuda")
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  emit("device", card=card, kind=kind, count=torch.cuda.device_count(),
       torch=torch.__version__, cuda=torch.version.cuda)

  import mujoco_mpc_tpu_torch  # noqa: F401  (sets TF32 off)
  from mujoco_mpc_tpu_torch.ops import (_build, cholesky, riccati_lane,
                                        sampling_lane, scoring, step_lane)
  from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
  from mujoco_mpc_tpu_torch.planners import (cross_entropy, ilqg, ilqs,
                                             robust, sample_gradient,
                                             sampling)
  from mujoco_mpc_tpu_torch.spline import Interpolation
  from mujoco_mpc_tpu_torch.tasks import registry

  assert torch.backends.cuda.matmul.allow_tf32 is False
  rng = np.random.default_rng(SEED)

  # ---- 2. build: every specialisation, all nvcc processes side by side --
  quad = registry.get_task("Quadruped Flat", device=device)
  cart = registry.get_task("Cartpole", device=device)
  swim = registry.get_task("Swimmer", device=device)
  spec = quad.lane_residual_spec()
  swim_spec = swim.lane_residual_spec()
  ilqg_config = ilqg.make_config(swim).replace(horizon=ILQG_HORIZON)
  sw = swim.plan_model
  sw_ndx = 2 * sw.nv
  assert (sw.nq, sw.nv, sw.nu, sw_ndx, swim_spec["dim"]) == (8, 8, 5, 16, 7)
  cost_terms = tuple(zip(quad.cost_spec.norm_types, quad.cost_spec.dims))
  quad_kw = dict(contact_types=(GEOM_SPHERE,),
                 contact_geoms=quad.plan_contact_geoms, residual=spec,
                 naux=spec["naux"], record_states=False)
  kernels = {
      "cartpole_states": step_lane.build_rollout_kernel(
          cart.plan_model, 20, 5),
      "quadruped_cost_sums": step_lane.build_rollout_kernel(
          quad.plan_model, HORIZON, SPLINE_POINTS, cost_terms=cost_terms,
          **quad_kw),
      "quadruped_residual_rows": step_lane.build_rollout_kernel(
          quad.plan_model, HORIZON, SPLINE_POINTS, **quad_kw),
      "quadruped_states": step_lane.build_rollout_kernel(
          quad.plan_model, HORIZON, SPLINE_POINTS,
          **dict(quad_kw, record_states=True)),
      # iLQG's line-search launch: feedback control, fluid (the planner of
      # phase 5 builds the same specialisation and finds it built)
      "swimmer_feedback": step_lane.build_rollout_kernel(
          sw, ILQG_HORIZON, 1, residual=swim_spec, naux=swim_spec["naux"],
          record_states=True, feedback=True),
      # free joint: the quaternion tangent of the feedback law, two steps
      "quadruped_feedback": step_lane.build_rollout_kernel(
          quad.plan_model, 2, 1, **dict(quad_kw, record_states=True),
          feedback=True),
  }
  qp_iters = ilqg_config.boxqp_iters
  riccati = {("swimmer", rt): riccati_lane.build_backward_kernel(
      sw_ndx, sw.nu, ILQG_HORIZON, qp_iters, rt) for rt in range(4)}
  riccati[("quadruped_size", 0)] = riccati_lane.build_backward_kernel(
      36, 12, ILQG_HORIZON, qp_iters, 0)
  riccati[("gate_size", 0)] = riccati_lane.build_backward_kernel(
      128, 32, ILQG_HORIZON, qp_iters, 0)
  riccati[("swimmer_h201", 0)] = riccati_lane.build_backward_kernel(
      sw_ndx, sw.nu, 201, qp_iters, 0)
  # the rest of the sampling family (phase 6): Swimmer at its own horizon
  # (201 steps) in cost-sum mode with fluid (robust's clean batch, iLQS's
  # sampler) and in feedback mode (iLQS's iLQG), Cartpole at its own
  # configuration in states mode (the lane planner's third branch); the
  # planners find them built
  swim_cfg = sampling.make_config(swim)
  cart_cfg = sampling.make_config(cart)
  assert (swim_cfg.horizon, swim_cfg.num_spline_points,
          swim_cfg.num_trajectory) == (201, 10, 10)
  kernels["swimmer_cost_sums_h201"] = step_lane.build_rollout_kernel(
      sw, swim_cfg.horizon, swim_cfg.num_spline_points, residual=swim_spec,
      naux=swim_spec["naux"], record_states=False,
      cost_terms=tuple(zip(swim.cost_spec.norm_types, swim.cost_spec.dims)))
  kernels["swimmer_feedback_h201"] = step_lane.build_rollout_kernel(
      sw, swim_cfg.horizon, 1, residual=swim_spec, naux=swim_spec["naux"],
      record_states=True, feedback=True)
  kernels["cartpole_states_own_config"] = step_lane.build_rollout_kernel(
      cart.plan_model, cart_cfg.horizon, cart_cfg.num_spline_points)
  e_tasks, e_kernels = ground_site_aux_builds(device)
  kernels.update(e_kernels)
  f_tasks, f_kernels, f_models = body_pair_builds(device)
  kernels.update(f_kernels)
  score_tasks = {"quadruped": quad, "swimmer": swim, "cartpole": cart}
  chol_ns = sorted({n for n, _ in CHOL_SIZES})
  t0 = time.perf_counter()
  # the slowest nvcc runs (the body-pair builds) start first
  order = list(f_kernels) + [n for n in kernels if n not in f_kernels]
  procs = {name: _build.start_build("lane_rollout.cu",
                                    kernels[name].build_defines())
           for name in order}
  procs.update({
      f"riccati_{name}_reg{rt}": _build.start_build(
          "riccati_backward.cu", k.build_defines())
      for (name, rt), k in riccati.items()})
  procs.update({
      f"score_fused_{name}": _build.start_build(
          "score_fused.cu", scoring.build_defines(t.cost_spec))
      for name, t in score_tasks.items()})
  procs.update({
      f"chol_solve_lanes_n{n}": _build.start_build(
          "chol_solve_lanes.cu", cholesky.build_defines(n)) for n in chol_ns})
  for name, (path, proc) in procs.items():
    _build.finish_build(proc)
  build_s = time.perf_counter() - t0
  emit("build", seconds=round(build_s, 2), dir=_build.build_dir(),
       libraries={name: dict(_build.BUILD_LOG[path])
                  for name, (path, _) in procs.items()})
  # the dynamic shared memory of B2 and B4 (ptxas counts static only)
  emit("build", case="layouts",
       riccati={f"{name}_reg{rt}": k.layout
                for (name, rt), k in riccati.items()},
       chol_solve_lanes={n: cholesky.layout(n) for n in chol_ns})

  # ---- 3. kernels vs their plain versions, on the card ----
  # (a) Cartpole, recorded states
  k_c = 256
  kern = kernels["cartpole_states"]
  m_c = cart.plan_model
  q0 = np.tile(m_c.qpos0.cpu().numpy()[:, None], (1, k_c)).astype(np.float32)
  q0 += 0.3 * rng.standard_normal(q0.shape).astype(np.float32)
  v0 = 0.5 * rng.standard_normal((m_c.nv, k_c)).astype(np.float32)
  vals = rng.uniform(-1, 1, (5 * m_c.nu, k_c)).astype(np.float32)
  args = [torch.as_tensor(a).to(device) for a in (q0, v0, vals)]
  got = kern(*args)
  want = kern.plain(*args)
  torch.cuda.synchronize()
  err_cart = float((got - want).abs().max())
  emit("kernels", case="cartpole_states", K=k_c, H=20,
       max_abs_err_states=err_cart, tol=TOL_STATES_CARTPOLE)
  assert got.shape == (20, m_c.nq + m_c.nv, k_c)
  assert err_cart <= TOL_STATES_CARTPOLE, err_cart

  w = quad.cost_spec.weights[:, None]

  def in_flight(args):
    """The same candidates started 1 m up with a random velocity: no foot
    reaches the floor within the horizon, so rollouts stay comparable."""
    qpos0, qvel0, values, aux = args
    qpos0 = qpos0.clone()
    qpos0[2] = 1.0
    qvel0 = torch.as_tensor(0.2 * rng.standard_normal(
        tuple(qvel0.shape)).astype(np.float32)).to(device)
    return qpos0, qvel0, values, aux

  def return_stats(ret, ret_p, ok):
    rel = ((ret - ret_p).abs() / torch.clamp(ret_p.abs(), min=1.0))[ok]
    qs = torch.quantile(rel, torch.tensor([0.5, 0.9, 0.99], device=device))
    return rel, dict(median_rel=float(qs[0]), p90_rel=float(qs[1]),
                     p99_rel=float(qs[2]), max_rel=float(rel.max()))

  # (b) Quadruped Flat, residual-row mode, in flight
  k_r = 256
  kern = kernels["quadruped_residual_rows"]
  args = in_flight(make_quadruped_inputs(quad, spec, None, k_r, rng, device))
  rows, final = kern(*args)
  rows_p, final_p = kern.plain(*args)
  torch.cuda.synchronize()
  err_cand = (rows - rows_p).abs().amax(dim=(0, 1))
  share_r = float((err_cand > TOL_ROWS).float().mean())
  emit("kernels", case="quadruped_residual_rows_in_flight", K=k_r, H=HORIZON,
       median_abs_err_rows=float(err_cand.median()),
       max_abs_err_rows=float(err_cand.max()),
       max_abs_err_final_state=float((final - final_p).abs().max()),
       share_over_tol=share_r, tol_rows=TOL_ROWS, tol_share=TOL_RETURN_SHARE)
  assert rows.shape == (HORIZON, spec["dim"], k_r)
  assert bool(torch.isfinite(rows).all()) and bool(torch.isfinite(final).all())
  assert share_r <= TOL_RETURN_SHARE, share_r

  # (c) Quadruped Flat, cost-sum mode (the main path's kernel, at its
  # shape), in flight: full-horizon returns agree
  kern = kernels["quadruped_cost_sums"]
  ground = make_quadruped_inputs(quad, spec, cost_terms, K_MAIN, rng, device)
  args = in_flight(ground)
  sums, final = kern(*args)
  sums_p, final_p = kern.plain(*args)
  torch.cuda.synchronize()
  ret = (w * sums).sum(dim=0) / HORIZON
  ret_p = (w * sums_p).sum(dim=0) / HORIZON
  ok = torch.isfinite(ret) & torch.isfinite(ret_p)
  rel, stats = return_stats(ret, ret_p, ok)
  share_f = float((rel > TOL_RETURN_REL).float().mean())
  err_ret = float((ret - ret_p).abs()[ok].max())
  emit("kernels", case="quadruped_cost_sums_in_flight", K=K_MAIN, H=HORIZON,
       max_abs_err_return=err_ret,
       max_abs_err_term_sums=float((sums - sums_p).abs()[:, ok].max()),
       share_over_tol=share_f, tol_return_rel=TOL_RETURN_REL,
       tol_share=TOL_RETURN_SHARE, nonfinite=int((~ok).sum()), **stats)
  assert bool(ok.all())
  assert share_f <= TOL_RETURN_SHARE, share_f

  # (d) the same kernel on the main path's own inputs (standing on the
  # floor): contact-rich rollouts diverge candidate by candidate, so the
  # full-horizon check is on the distribution; this run times the plain
  # version at the main path's shape
  args = ground
  sums, final = kern(*args)
  sums_floor, final_floor = sums, final
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  sums_p, final_p = kern.plain(*args)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t0) * 1e3
  ret = (w * sums).sum(dim=0) / HORIZON
  ret_p = (w * sums_p).sum(dim=0) / HORIZON
  bad = ~torch.isfinite(final).all(dim=0)
  bad_p = ~torch.isfinite(final_p).all(dim=0)
  rel, stats = return_stats(ret, ret_p, ~(bad | bad_p))
  kernel_ms = time_cuda(lambda: kern(*args), 20)
  # bound: bytes each moved once vs float32 operations of this run
  nbytes = 4 * sum(int(np.prod(a.shape)) for a in (*args, sums, final))
  one = [a[:, :1].cpu() for a in args]
  flops_per_candidate = count_flops(lambda: kern.plain(*one))
  flops = flops_per_candidate * K_MAIN
  bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
  ops_ms = flops / H100_F32_FLOPS * 1e3
  bound_ms = max(bytes_ms, ops_ms)
  emit("kernels", case="quadruped_cost_sums_on_floor", K=K_MAIN, H=HORIZON,
       nonfinite_share_kernel=float(bad.float().mean()),
       nonfinite_share_plain=float(bad_p.float().mean()),
       share_within_1e_3=float((rel <= 1e-3).float().mean()),
       tol_median_rel=TOL_GROUND_MEDIAN_REL, kernel_ms=kernel_ms,
       plain_ms=plain_ms, bytes=nbytes,
       flops_per_candidate=flops_per_candidate, bytes_ms=bytes_ms,
       ops_ms=ops_ms, card=card, **stats)
  assert float(bad.float().mean()) <= TOL_NONFINITE_SHARE
  assert stats["median_rel"] <= TOL_GROUND_MEDIAN_REL, stats

  # (e) the contact path step by step: the state-recording build rolls out
  # the main path's inputs; the plain version repeats every step from the
  # kernel's own recorded state. The control repeats it once more from
  # that state perturbed in its last bits, plain version against itself.
  # The cost-sum build follows the same trajectory, so its final state is
  # the step from the last recorded state, and its term sums are the cost
  # of the recorded residual rows.
  kern = kernels["quadruped_states"]
  qpos0, qvel0, values, aux_all = ground
  naux = spec["naux"]
  aux = aux_all[:naux].contiguous()
  rec = kern(qpos0, qvel0, values, aux)
  torch.cuda.synchronize()
  nq, nv, nu = quad.plan_model.nq, quad.plan_model.nv, quad.plan_model.nu
  assert rec.shape == (HORIZON, nq + nv + spec["dim"], K_MAIN)
  gen_c = torch.Generator(device=device).manual_seed(SEED)

  def perturbed(x):
    return x * (1.0 + CONTROL_PERTURBATION * torch.randn(
        x.shape, generator=gen_c, device=device))

  def rel_err(a, b):
    return ((a - b).abs() / torch.clamp(b.abs(), min=1.0)).amax(dim=0)

  step_err, row_err, ctl_err, sane = [], [], [], []
  for t in range(HORIZON):
    node = min(int(t * SPLINE_POINTS / max(HORIZON - 1, 1)),
               SPLINE_POINTS - 1)
    ctrl = values[node * nu:(node + 1) * nu]
    q_n, v_n, res = kern.step_array(
        rec[t, :nq], rec[t, nq:nq + nv], ctrl, t, aux)
    nxt = torch.cat([q_n, v_n])
    q_c, v_c, _ = kern.step_array(
        perturbed(rec[t, :nq]), perturbed(rec[t, nq:nq + nv]), ctrl, t, aux)
    after = rec[t + 1, :nq + nv] if t + 1 < HORIZON else final_floor
    step_err.append(rel_err(after, nxt))
    ctl_err.append(rel_err(torch.cat([q_c, v_c]), nxt))
    row_err.append(rel_err(rec[t, nq + nv:], res))
    # a rollout that has blown up (the planner poisons those) carries
    # states at which float32 rows mean nothing: leave them out
    sane.append((rec[t, :nq].abs().amax(dim=0) < 10.0) &
                (rec[t, nq:nq + nv].abs().amax(dim=0) < 100.0))
  step_err = torch.stack(step_err)
  row_err = torch.stack(row_err)
  ctl_err = torch.stack(ctl_err)
  okp = torch.stack(sane) & torch.isfinite(step_err) & \
      torch.isfinite(row_err) & torch.isfinite(ctl_err)
  share_step = float((step_err[okp] > TOL_STEP).float().mean())
  share_ctl = float((ctl_err[okp] > TOL_STEP).float().mean())
  share_last = float((step_err[-1][okp[-1]] > TOL_STEP).float().mean())
  med_step = float(step_err[okp].median())
  share_rows = float((row_err[okp] > TOL_ROWS).float().mean())
  # the cost-sum build's term sums against the plain cost of the recorded
  # rows, over the rollouts that stayed finite
  norm_p = aux_all[naux:]
  sums_rec, off = [], 0
  for n, (ntype, dim) in enumerate(cost_terms):
    rows_n = [rec[:, nq + nv + off + i] for i in range(dim)]   # each (H, K)
    sums_rec.append(step_lane.lane_term_cost(
        rows_n, ntype, norm_p[2 * n], norm_p[2 * n + 1]).sum(dim=0))
    off += dim
  ret_k = (w * sums_floor).sum(dim=0) / HORIZON
  ret_rec = (w * torch.stack(sums_rec)).sum(dim=0) / HORIZON
  alive = torch.isfinite(final_floor).all(dim=0) & torch.isfinite(ret_rec)
  rel_sums, stats_sums = return_stats(ret_k, ret_rec, alive)
  share_sums = float((rel_sums > TOL_RETURN_REL).float().mean())
  emit("kernels", case="quadruped_states_step_by_step", K=K_MAIN, H=HORIZON,
       pairs=int(okp.numel()), left_out_pairs=int((~okp).sum()),
       median_step_err=med_step, share_over_tol=share_step,
       control_share_over_tol=share_ctl,
       control_median_err=float(ctl_err[okp].median()),
       cost_sum_final_state_share_over_tol=share_last,
       cost_sums_vs_recorded_rows_share_over_tol=share_sums,
       cost_sums_vs_recorded_rows=stats_sums,
       median_rows_err=float(row_err[okp].median()),
       max_rows_err=float(row_err[okp].max()), share_rows_over_tol=share_rows,
       tol_step=TOL_STEP, tol_share=TOL_STEP_SHARE,
       tol_vs_control=TOL_STEP_VS_CONTROL,
       tol_median=TOL_STEP_MEDIAN, tol_rows=TOL_ROWS,
       tol_rows_share=TOL_RETURN_SHARE, tol_return_rel=TOL_RETURN_REL)
  assert float((~okp).float().mean()) <= TOL_NONFINITE_SHARE
  assert share_rows <= TOL_RETURN_SHARE, share_rows
  assert med_step <= TOL_STEP_MEDIAN, med_step
  assert share_step <= TOL_STEP_SHARE, share_step
  assert share_step <= TOL_STEP_VS_CONTROL * share_ctl, (share_step, share_ctl)
  assert share_last <= TOL_STEP_SHARE, share_last
  assert share_sums <= TOL_RETURN_SHARE, share_sums

  # (f) Riccati kernel at Swimmer's size: four regularisation types, loose
  # and tight limits
  reg = torch.tensor(1e-2, device=device)
  riccati_rows, flip_cases, err_riccati = [], 0, 0.0
  for rt in range(4):
    for tight in (False, True):
      prob = riccati_problem(ILQG_HORIZON, sw_ndx, sw.nu,
                             seed=10 * rt + tight, tight_limits=tight,
                             device=device)
      row = check_riccati(riccati[("swimmer", rt)], prob, reg,
                          TOL_RICCATI_ABS)
      riccati_rows.append(dict(reg_type=rt, tight_limits=tight, **row))
      flip_cases += row["first_flip_step"] >= 0
      err_riccati = max(err_riccati, row["max_abs_err_k"],
                        row["max_abs_err_K"])
      assert row["within_tol"], row
      assert row["ok"] and row["ok_plain"], row
      assert row["flip_share"] <= TOL_QP_FLIP_SHARE, row
      assert tight or row["first_flip_step"] < 0, row
      assert (row["clamped_share"] > 0.05) == tight, row
  emit("kernels", case="riccati_swimmer", ndx=sw_ndx, nu=sw.nu,
       T=ILQG_HORIZON, qp_iters=qp_iters, cases=riccati_rows,
       cases_with_a_flip=flip_cases, tol_abs=TOL_RICCATI_ABS,
       tol_rel=TOL_RICCATI_REL, tol_flip_share=TOL_QP_FLIP_SHARE)
  assert flip_cases <= TOL_QP_FLIP_CASES, flip_cases

  # its time at the iLQG path's shape, beside the plain version and the bound
  prob = riccati_problem(ILQG_HORIZON, sw_ndx, sw.nu, seed=0,
                         tight_limits=False, device=device)
  kern = riccati[("swimmer", 0)]
  riccati_ms = time_cuda(lambda: kern(*prob, reg), 50)
  riccati_device_ms = device_ms(lambda: kern(*prob, reg), 50,
                                "riccati_backward")
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(3):                      # warm: the checks above ran it
    kern.plain(*prob, reg)
  torch.cuda.synchronize()
  riccati_plain_ms = (time.perf_counter() - t0) * 1e3 / 3
  r_bytes, r_flops = riccati_work(sw_ndx, sw.nu, ILQG_HORIZON, qp_iters)
  riccati_bytes_ms = r_bytes / H100_BYTES_PER_S * 1e3
  riccati_ops_ms = r_flops / H100_F32_FLOPS * 1e3
  emit("kernels", case="riccati_swimmer_time", kernel_ms=riccati_ms,
       device_ms=riccati_device_ms, layout=kern.layout,
       plain_ms=riccati_plain_ms, bytes=r_bytes, flops=r_flops,
       bytes_ms=riccati_bytes_ms, ops_ms=riccati_ops_ms,
       dependent_steps=ILQG_HORIZON - 1, card=card)

  # (g) the same kernel at a quadruped's size, at the gate's largest size
  # (its workspace just fits shared memory) and at Swimmer's own default
  # horizon
  wide_rows = []
  for name, ndx_w, nu_w, t_w, tight in (
      ("quadruped_size", 36, 12, ILQG_HORIZON, True),
      ("gate_size", 128, 32, ILQG_HORIZON, False),
      ("swimmer_h201", sw_ndx, sw.nu, 201, False)):
    kern = riccati[(name, 0)]
    prob = riccati_problem(t_w, ndx_w, nu_w, seed=7 * ndx_w + nu_w,
                           tight_limits=tight, device=device)
    atol = TOL_RICCATI_ABS if ndx_w < 36 else TOL_RICCATI_ABS_WIDE
    row = check_riccati(kern, prob, reg, atol)
    ms = time_cuda(lambda: kern(*prob, reg), 10)
    wb, wf = riccati_work(ndx_w, nu_w, t_w, qp_iters)
    wide_rows.append(dict(
        name=name, ndx=ndx_w, nu=nu_w, T=t_w, tight_limits=tight,
        kernel_ms=ms, device_ms=device_ms(lambda: kern(*prob, reg), 10,
                                          "riccati_backward"),
        workspace_in_shared_memory=kern.layout["workspace_in_shared_memory"],
        layout=kern.layout,
        bound_ms=max(wb / H100_BYTES_PER_S, wf / H100_F32_FLOPS) * 1e3,
        tol_abs=atol, **row))
    assert row["within_tol"] and row["ok"] and row["ok_plain"], row
    assert row["flip_share"] <= TOL_QP_FLIP_SHARE, row
  emit("kernels", case="riccati_wide", cases=wide_rows, card=card)

  # (h) Swimmer, feedback mode with fluid: random gains of realistic size
  # around a perturbed nominal, K = 8 (the action line search) and K = 4
  # (the nominal one); no contacts, so every recorded number is compared
  kern = kernels["swimmer_feedback"]
  d0_s = swim.make_data()
  nqv = sw.nq + sw.nv

  def swimmer_inputs(k):
    x0 = torch.cat([d0_s.qpos, d0_s.qvel]).cpu().numpy()
    x_nom = x0[None] + 0.1 * rng.standard_normal((ILQG_HORIZON, nqv))
    blocks = np.concatenate([
        rng.uniform(-0.8, 0.8, (ILQG_HORIZON, sw.nu)),
        0.3 * rng.standard_normal((ILQG_HORIZON, sw.nu)),
        0.5 * rng.standard_normal((ILQG_HORIZON, sw.nu * sw_ndx)),
        x_nom], axis=1).astype(np.float32)
    assert blocks.shape[1] == kern.stride == 106
    qpos0 = x0[:sw.nq, None] + 0.1 * rng.standard_normal((sw.nq, k))
    qvel0 = 0.3 * rng.standard_normal((sw.nv, k))
    values = np.stack([rng.uniform(0, 1, k), rng.uniform(0, 1, k)])
    aux = np.tile(np.array([0.5, 0.5])[:, None], (1, k))
    return [torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)
            for a in (qpos0, qvel0, values, aux, blocks.reshape(-1))]

  args8 = swimmer_inputs(8)
  got = kern(*args8)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  want = kern.plain(*args8)
  torch.cuda.synchronize()
  fb_plain_ms = (time.perf_counter() - t0) * 1e3
  err_fb = float((got - want).abs().max())
  ctrl_rows = want[:, nqv:nqv + sw.nu]
  fb_ms8 = time_cuda(lambda: kern(*args8), 50)
  args4 = swimmer_inputs(4)
  fb_ms4 = time_cuda(lambda: kern(*args4), 50)
  err_fb4 = float((kern(*args4) - kern.plain(*args4)).abs().max())
  fb_bytes = 4 * (sum(int(a.numel()) for a in args8) + int(got.numel()))
  one = [a[:, :1].cpu() for a in args8[:4]] + [args8[4].cpu()]
  fb_flops = 8 * count_flops(lambda: kern.plain(*one))
  fb_bytes_ms = fb_bytes / H100_BYTES_PER_S * 1e3
  fb_ops_ms = fb_flops / H100_F32_FLOPS * 1e3
  emit("kernels", case="swimmer_feedback_states", K=8, H=ILQG_HORIZON,
       max_abs_err=err_fb, max_abs_err_K4=err_fb4, tol=TOL_STATES_SWIMMER,
       share_of_controls_on_the_clip=float(
           (ctrl_rows.abs() >= 1.0).float().mean()),
       kernel_ms_K8=fb_ms8, kernel_ms_K4=fb_ms4, plain_ms=fb_plain_ms,
       bytes=fb_bytes, flops=fb_flops, bytes_ms=fb_bytes_ms,
       ops_ms=fb_ops_ms, card=card)
  assert got.shape == (ILQG_HORIZON, nqv + swim_spec["dim"], 8)
  assert bool(torch.isfinite(got).all())
  assert err_fb <= TOL_STATES_SWIMMER and err_fb4 <= TOL_STATES_SWIMMER, \
      (err_fb, err_fb4)

  # (i) Quadruped Flat, feedback mode, one step from the same state: the
  # free joint takes the quaternion tangent on the card. In flight the step
  # is smooth and every candidate is held to the tolerance; standing on the
  # floor the comparison is per share of candidates beside the control (the
  # plain version against itself, its input perturbed in the last bits).
  kern = kernels["quadruped_feedback"]
  k_q = 1024
  qm = quad.plan_model
  qpos0, qvel0, _, aux_q = make_quadruped_inputs(quad, spec, None, k_q, rng,
                                                 device)
  qpos0 = qpos0 + torch.as_tensor(np.concatenate([
      0.01 * rng.standard_normal((3, k_q)),
      0.05 * rng.standard_normal((4, k_q)),
      0.05 * rng.standard_normal((12, k_q))]).astype(np.float32)).to(device)
  qpos0[3:7] = qpos0[3:7] / qpos0[3:7].norm(dim=0, keepdim=True)
  qvel0 = torch.as_tensor(0.2 * rng.standard_normal(
      (qm.nv, k_q)).astype(np.float32)).to(device)
  d0_q = quad.make_data()
  x_home = torch.cat([d0_q.qpos, d0_q.qvel]).cpu().numpy()
  ndx_q = 2 * qm.nv
  blocks = np.concatenate([
      np.tile(np.asarray(quad.home_qpos[7:])[None], (2, 1)),
      0.05 * rng.standard_normal((2, qm.nu)),
      0.3 * rng.standard_normal((2, qm.nu * ndx_q)),
      np.tile(x_home[None], (2, 1))], axis=1).astype(np.float32)
  table = torch.as_tensor(blocks.reshape(-1)).to(device)
  values = torch.as_tensor(np.stack([
      rng.uniform(0, 1, k_q), rng.uniform(0, 1, k_q)]).astype(
          np.float32)).to(device)
  nq, nv, nu = qm.nq, qm.nv, qm.nu
  tab2 = table.reshape(2, -1)
  qvel0 = qvel0.contiguous()
  gen_q = torch.Generator(device=device).manual_seed(SEED + 1)
  pert = lambda x: x * (1.0 + CONTROL_PERTURBATION * torch.randn(
      x.shape, generator=gen_q, device=device))
  rel = lambda a, b: ((a - b).abs() /
                      torch.clamp(b.abs(), min=1.0)).amax(dim=0)
  lo_q, hi_q = qm.actuator_ctrlrange[:, 0:1], qm.actuator_ctrlrange[:, 1:2]

  def plain_step(qp, qv):
    u = torch.stack(kern.feedback_ctrl(
        0, list(qp), list(qv), values[0], values[1], tab2))
    q_n, v_n, res = kern.step_array(qp, qv, u, 0, aux_q)
    return torch.cat([q_n, v_n]), res, u

  for where in ("in_flight", "on_floor"):
    qp = qpos0.clone()
    if where == "in_flight":
      qp[2] = 1.0
    qp = qp.contiguous()
    rec = kern(qp, qvel0, values, aux_q, table)
    torch.cuda.synchronize()
    nxt, res, u_plain = plain_step(qp, qvel0)
    nxt_c, _, _ = plain_step(pert(qp), pert(qvel0))
    step_q, ctl_q = rel(rec[1, :nq + nv], nxt), rel(nxt_c, nxt)
    rows_q = rel(rec[0, nq + nv:], res)
    share_q = float((step_q > TOL_STEP).float().mean())
    share_qc = float((ctl_q > TOL_STEP).float().mean())
    share_qr = float((rows_q > TOL_ROWS).float().mean())
    med_q, med_qc = float(step_q.median()), float(ctl_q.median())
    emit("kernels", case="quadruped_feedback_one_step", where=where, K=k_q,
         median_step_err=med_q, max_step_err=float(step_q.max()),
         share_over_tol=share_q, control_median_err=med_qc,
         control_share_over_tol=share_qc, share_rows_over_tol=share_qr,
         max_rows_err=float(rows_q.max()),
         share_of_controls_on_the_clip=float(
             ((u_plain <= lo_q) | (u_plain >= hi_q)).float().mean()),
         tol_step=TOL_STEP, tol_share=TOL_STEP_SHARE,
         tol_vs_control=TOL_STEP_VS_CONTROL, tol_rows=TOL_ROWS)
    assert bool(torch.isfinite(rec).all())
    assert float((rec[0, :nq + nv] - torch.cat([qp, qvel0])).abs().max()) \
        == 0.0
    assert share_qr <= TOL_RETURN_SHARE, share_qr
    if where == "in_flight":
      assert share_q <= TOL_RETURN_SHARE, share_q
      assert med_q <= TOL_STEP_MEDIAN, med_q
    else:
      # these states (feet pressed into the floor, random joint offsets)
      # are rougher than the planner's: the control itself is over the
      # tolerance on a fifth of them, so the kernel is held to the control
      assert share_q <= TOL_STEP_VS_CONTROL * share_qc + 0.01, \
          (share_q, share_qc)
      assert med_q <= 3.0 * med_qc + TOL_STEP_MEDIAN, (med_q, med_qc)

  # (j) fused scoring kernel: random residual rows at each ported task's
  # cost, K=4096 candidates, horizon 36 (the quadruped's is the size for
  # the time and the bound); then at the shapes its paths hand it: robust's
  # noisy batch (Swimmer, K=16, T=201) as the pipeline rollouts' (K, T, nr)
  # batch seen through a permuted view, the kernel's strided input, and as
  # (T, nr, K) rows, and the Cartpole lane planner's (K=10, T=101) rows;
  # each with its device time and the device kernels one scorer call makes
  # (1: no copy of the residuals or the norm parameters). No single
  # PyTorch call computes the function.
  score_rows, err_score = [], 0.0
  score_cases = [(name, task, K_MAIN, HORIZON, True)
                 for name, task in score_tasks.items()]
  score_cases += [("swimmer", swim, 16, swim_cfg.horizon, False),
                  ("swimmer", swim, 16, swim_cfg.horizon, True),
                  ("cartpole", cart, cart_cfg.num_trajectory,
                   cart_cfg.horizon, True)]
  for name, task, k, t_hor, rows in score_cases:
    cs = task.cost_spec
    batch = torch.as_tensor(rng.standard_normal(
        (k, t_hor, cs.num_residual)).astype(np.float32)).to(device)
    res = batch.permute(1, 2, 0)
    if rows:
      res = res.contiguous()
    scorer = scoring.make_scorer(cs, device)
    assert scorer.route == "kernel", scorer.route
    got = scorer(res)
    want = scoring.score_reference(batch, cs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    within = bool(((got - want).abs() <= TOL_SCORE +
                   TOL_SCORE * want.abs()).all())
    called = device_kernels(lambda: scorer(res))
    row = dict(task=name, T=t_hor, nr=cs.num_residual, K=k,
               residuals="rows (T, nr, K)" if rows
               else "batch (K, T, nr) permuted",
               strides=list(res.stride()), layout=scoring.layout(
                   k, t_hor, scoring.sm_count(torch.cuda.current_device())),
               max_abs_err=err, within_tol=within, device_kernels=called,
               device_ms=device_ms(lambda: scorer(res), 50, "score_fused"))
    if name == "quadruped" or k != K_MAIN:
      sb, so = score_work(cs, t_hor, k)
      row.update(kernel_ms=time_cuda(lambda: scorer(res), 50),
                 plain_ms=time_cuda(
                     lambda: scoring.score_reference(batch, cs), 20),
                 bytes=sb, flops=so, bytes_ms=sb / H100_BYTES_PER_S * 1e3,
                 ops_ms=so / H100_F32_FLOPS * 1e3, library_ms=None)
    score_rows.append(row)
    err_score = max(err_score, err)
    assert got.shape == (k,) and within, row
    # one device kernel a call (the profiler sees the device: device_ms)
    assert len(called) == 1 and all(
        "score_fused" in key and round(n) == 1 for key, n in called.items()), \
        row
  score_main = score_rows[0]
  emit("kernels", case="score_fused", cases=score_rows, tol=TOL_SCORE,
       card=card)

  # (k) batched Cholesky solve at the sizes of the JAX suite, at Swimmer's
  # (the robust path hands it n = 8, K = 16) and at n = 18, K = 4096 (the
  # size for the time and the bound), beside torch.linalg.solve on the same
  # systems (the library call, timed here only)
  chol_rows, err_chol = [], 0.0
  for n, k in CHOL_SIZES:
    a, b = spd_batch(n, k, rng, device)
    x = cholesky.chol_solve_lanes(a, b)
    xp = cholesky.chol_solve_lanes_plain(a, b)
    torch.cuda.synchronize()
    err = float((x - xp).abs().max())
    within = bool(((x - xp).abs() <= TOL_CHOL + TOL_CHOL * xp.abs()).all())
    am, bm = a.permute(2, 0, 1).contiguous(), b.T.contiguous()[..., None]
    cb, co = chol_work(n, k)
    vmapped = torch.func.vmap(cholesky.spd_solve)
    row = dict(n=n, K=k, max_abs_err=err, within_tol=within,
               kernel_ms=time_cuda(lambda: cholesky.chol_solve_lanes(a, b),
                                   50),
               device_ms=device_ms(lambda: cholesky.chol_solve_lanes(a, b),
                                   50, "chol_solve_lanes"),
               host_ms_per_call=call_ms(
                   lambda: cholesky.chol_solve_lanes(a, b), 200),
               host_ms_per_vmapped_call=call_ms(
                   lambda: vmapped(am, bm[..., 0]), 200),
               layout=cholesky.layout(n),
               library_ms=time_cuda(lambda: torch.linalg.solve(am, bm), 20),
               plain_ms=host_ms(lambda: cholesky.chol_solve_lanes_plain(
                   a, b)),
               bytes=cb, flops=co, bytes_ms=cb / H100_BYTES_PER_S * 1e3,
               ops_ms=co / H100_F32_FLOPS * 1e3)
    chol_rows.append(row)
    err_chol = max(err_chol, err)
    assert x.shape == (n, k) and within, row
  chol_main = chol_rows[-1]
  emit("kernels", case="chol_solve_lanes", cases=chol_rows, tol=TOL_CHOL,
       card=card)

  # ---- 4. main path: the planner a user builds, on the card ----
  config = sampling.SamplingConfig(
      num_trajectory=K_MAIN, num_spline_points=SPLINE_POINTS,
      interp=Interpolation.ZERO, exploration=(EXPLORATION, 0.0),
      horizon=HORIZON)
  planner = sampling_lane.LaneSamplingPlanner(
      quad, config, device=device, contact_types=(GEOM_SPHERE,))
  gen = torch.Generator(device=device).manual_seed(SEED)
  d0 = quad.make_data()
  planner.optimize(gen, d0)            # warm-up (loads the built library)
  torch.cuda.synchronize()
  step_lane.launch_count = 0
  infos = []
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(ITERATIONS):
    infos.append(planner.optimize(gen, d0))
  end.record()
  torch.cuda.synchronize()
  launches = main_launches = step_lane.launch_count
  iter_ms = start.elapsed_time(end) / ITERATIONS
  assert launches == ITERATIONS, (launches, ITERATIONS)
  nominal = [float(i["nominal_return"]) for i in infos]
  best = [float(i["best_return"]) for i in infos]
  for i, info in enumerate(infos):
    r = info["returns"]
    assert r.shape == (K_MAIN,)
    assert bool((torch.isfinite(r)).all()), "non-finite return"
    assert best[i] <= nominal[i], (i, best[i], nominal[i])
    if i:
      assert nominal[i] <= nominal[i - 1], (i, nominal[i], nominal[i - 1])
  assert best[-1] < 1e6
  action = planner.action(0.0)
  assert action.shape == (quad.plan_model.nu,)
  assert bool(torch.isfinite(action).all())
  diverged = [int((i["returns"] >= 1e6).sum()) for i in infos]
  emit("main_path", task="Quadruped Flat", K=K_MAIN, H=HORIZON,
       P=SPLINE_POINTS, iterations=ITERATIONS, launches=launches,
       ms_per_iteration=iter_ms, kernel_ms=kernel_ms,
       rollouts_per_s=K_MAIN / (iter_ms * 1e-3),
       nominal_first=nominal[0], nominal_last=nominal[-1],
       best_last=best[-1], diverged_last=diverged[-1],
       diverged_per_iteration=diverged, card=card)

  # ---- 5. iLQG path: Swimmer at full width, on the card ----
  planner = ilqg.ILQGPlanner(swim, ilqg_config, device=device)
  assert planner.routes == dict(line_search="kernel", backward="kernel"), \
      planner.routes
  cfg = planner.config
  assert (cfg.horizon, cfg.num_alphas, cfg.num_fb_scales, cfg.boxqp_iters,
          cfg.reg_type) == (ILQG_HORIZON, 8, 4, 6, ilqg.REG_CONTROL)
  d0 = swim.make_data()
  planner.optimize(None, d0)           # warm-up (loads the built libraries)
  torch.cuda.synchronize()
  planner.policy = ilqg.initial_policy(sw, cfg, d0)
  stage_events = []                # one {stage: event} per iteration

  def mark(stage):
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    stage_events[-1][stage] = event

  step_lane.launch_count = 0
  riccati_lane.launch_count = 0
  infos = []
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(ILQG_ITERATIONS):
    stage_events.append({})
    infos.append(planner.optimize(None, d0, mark=mark))
  end.record()
  torch.cuda.synchronize()
  lane_launches = step_lane.launch_count
  riccati_launches = riccati_lane.launch_count
  ilqg_ms = start.elapsed_time(end) / ILQG_ITERATIONS
  sweeps = [i["backward_sweeps"] for i in infos]
  readbacks = [i["host_readbacks"] for i in infos]
  stage_names = ("start", "nominal_line_search", "derivatives", "backward",
                 "action_line_search")
  stage_ms = {n: float(np.mean([e[prev].elapsed_time(e[n])
                                for e in stage_events]))
              for prev, n in zip(stage_names, stage_names[1:])}
  nominal = [float(i["nominal_return"]) for i in infos]
  best = [float(i["best_return"]) for i in infos]
  emit("ilqg_path", task="Swimmer", H=ILQG_HORIZON, ndx=sw_ndx, nu=sw.nu,
       num_fb_scales=cfg.num_fb_scales, num_alphas=cfg.num_alphas,
       iterations=ILQG_ITERATIONS, ms_per_iteration=ilqg_ms,
       stage_ms=stage_ms,
       glue_ms=ilqg_ms - sum(stage_ms.values()),
       rollout_kernel_launches=lane_launches,
       riccati_kernel_launches=riccati_launches,
       backward_sweeps_per_iteration=sweeps,
       host_readbacks_per_iteration=readbacks,
       nominal_return=nominal, best_return=best,
       backward_ok=[bool(i["backward_ok"]) for i in infos],
       reg=[float(i["reg"]) for i in infos],
       alpha=[float(i["alpha"]) for i in infos],
       feedback_scaling=[float(i["feedback_scaling"]) for i in infos],
       riccati_kernel_ms=riccati_ms, rollout_kernel_ms_K4=fb_ms4,
       rollout_kernel_ms_K8=fb_ms8, card=card)
  assert lane_launches == 2 * ILQG_ITERATIONS, lane_launches
  assert riccati_launches == sum(sweeps) >= ILQG_ITERATIONS, \
      (riccati_launches, sweeps)
  for i in range(ILQG_ITERATIONS):
    assert np.isfinite(nominal[i]) and np.isfinite(best[i])
    assert nominal[i] < 1e6 and best[i] < 1e6, (i, nominal[i], best[i])
    assert best[i] <= nominal[i], (i, best[i], nominal[i])
    if i:
      assert nominal[i] <= nominal[i - 1] * (1 + 1e-5), \
          (i, nominal[i], nominal[i - 1])
  assert best[-1] < nominal[0], (best[-1], nominal[0])
  action = planner.action(0.0, torch.cat([d0.qpos, d0.qvel]))
  assert action.shape == (sw.nu,) and bool(torch.isfinite(action).all())

  # the same iterations once more, outside the timed and counted window:
  # a second planner whose two kernels also run their plain versions on
  # every input the planner hands them
  riccati_checks, rollout_errs = [], []
  build_backward, build_rollout = (riccati_lane.build_backward_kernel,
                                   step_lane.build_rollout_kernel)

  def checked_backward(*a, **kw):
    kern = build_backward(*a, **kw)

    def backward(*args):
      riccati_checks.append(check_riccati_on_path(kern, args))
      return kern(*args)

    return backward

  def checked_rollout(*a, **kw):
    kern = build_rollout(*a, **kw)

    def rollout(*args):
      got = kern(*args)
      rollout_errs.append(float((got - kern.plain(*args)).abs().max()))
      return got

    return rollout

  riccati_lane.build_backward_kernel = checked_backward
  step_lane.build_rollout_kernel = checked_rollout
  try:
    checked = ilqg.ILQGPlanner(swim, ilqg_config, device=device)
  finally:
    riccati_lane.build_backward_kernel = build_backward
    step_lane.build_rollout_kernel = build_rollout
  t0 = time.perf_counter()
  checked_infos = [checked.optimize(None, d0)
                   for _ in range(ILQG_CHECKED_ITERATIONS)]
  torch.cuda.synchronize()
  emit("ilqg_path", case="kernels_on_the_planners_inputs",
       iterations=ILQG_CHECKED_ITERATIONS, seconds=time.perf_counter() - t0,
       riccati=riccati_checks, rollout_max_abs_err=rollout_errs,
       best_return=[float(i["best_return"]) for i in checked_infos],
       tol_riccati_abs=TOL_RICCATI_ABS, tol_riccati_rel=TOL_RICCATI_REL,
       tol_vs_plain32=TOL_RICCATI_VS_PLAIN32, tol_states=TOL_STATES_SWIMMER)
  assert len(riccati_checks) == sum(sweeps[:ILQG_CHECKED_ITERATIONS]), \
      (len(riccati_checks), sweeps)
  assert len(rollout_errs) == 2 * ILQG_CHECKED_ITERATIONS
  assert all(r["passes"] for r in riccati_checks), riccati_checks
  assert max(rollout_errs) <= TOL_STATES_SWIMMER, rollout_errs
  assert np.allclose([float(i["best_return"]) for i in checked_infos],
                     best[:ILQG_CHECKED_ITERATIONS], rtol=1e-5)

  # ---- 6. the rest of the sampling family, each on its own path ----
  counters = dict(rollout=step_lane, riccati=riccati_lane, scoring=scoring,
                  cholesky=cholesky)
  path_launches = {}

  def sampling_checks(infos, nominal_of, best_is_min=True):
    """No NaN return (poisoned candidates read 1e6), a finite best; where
    the winner is the argmin of the returns, the best no worse than the
    nominal (candidate 0), every iteration."""
    best = [float(i["best_return"]) for i in infos]
    nominal = [float(nominal_of(i)) for i in infos]
    for i, info in enumerate(infos):
      r = info["returns"]
      assert not bool(torch.isnan(r).any()), "NaN return"
      assert not best_is_min or best[i] <= nominal[i] + 1e-6 * abs(
          nominal[i]), (i, best[i], nominal[i])
    assert best[-1] < 1e6, best
    return best, nominal, [int((i["returns"] >= 1e6).sum()) for i in infos]

  # (a) cross-entropy on Quadruped Flat at the flagship's width, lane route
  cem_cfg = cross_entropy.make_config(quad).replace(
      num_trajectory=K_MAIN, num_spline_points=SPLINE_POINTS,
      horizon=HORIZON, n_elite=max(K_MAIN // 10, 2))
  planner = cross_entropy.CrossEntropyPlanner(
      quad, cem_cfg, lane=True, device=device, contact_types=(GEOM_SPHERE,))
  assert planner.routes == dict(rollouts="rollout_kernel",
                                scoring="rollout_kernel"), planner.routes
  gen = torch.Generator(device=device).manual_seed(SEED)
  infos, cem_ms, launches, syncs = run_path(
      planner, quad.make_data(), CEM_ITERATIONS, counters, gen)
  best, nominal, poisoned = sampling_checks(infos, lambda i: i["returns"][0])
  path_launches["cem_path"] = launches
  emit("cem_path", task="Quadruped Flat", K=K_MAIN, H=HORIZON,
       P=SPLINE_POINTS, n_elite=cem_cfg.n_elite,
       std_initial=cem_cfg.std_initial, std_min=cem_cfg.std_min,
       iterations=CEM_ITERATIONS, ms_per_iteration=cem_ms,
       rollouts_per_s=K_MAIN / (cem_ms * 1e-3), launches=launches,
       host_syncs_per_iteration=syncs, routes=planner.routes,
       best_return=best, nominal_return=nominal,
       elite_avg_return=[float(i["elite_avg_return"]) for i in infos],
       poisoned_per_iteration=poisoned, card=card)
  assert launches == dict(rollout=CEM_ITERATIONS, riccati=0, scoring=0,
                          cholesky=0), launches

  # (b) sample-gradient, same task and size: the noisy batch (K-4) and the
  # 4 gradient candidates, two launches of one build an iteration
  sg_cfg = sample_gradient.make_config(quad).replace(
      num_trajectory=K_MAIN, num_spline_points=SPLINE_POINTS,
      horizon=HORIZON, exploration=EXPLORATION)
  planner = sample_gradient.SampleGradientPlanner(
      quad, sg_cfg, lane=True, device=device, contact_types=(GEOM_SPHERE,))
  infos, sg_ms, launches, syncs = run_path(
      planner, quad.make_data(), SG_ITERATIONS, counters, gen)
  best, nominal, poisoned = sampling_checks(
      infos, lambda i: i["nominal_return"])
  path_launches["sample_gradient_path"] = launches
  emit("sample_gradient_path", task="Quadruped Flat", K=K_MAIN, H=HORIZON,
       P=SPLINE_POINTS, num_gradient=sg_cfg.num_gradient,
       iterations=SG_ITERATIONS, ms_per_iteration=sg_ms,
       rollouts_per_s=K_MAIN / (sg_ms * 1e-3), launches=launches,
       host_syncs_per_iteration=syncs, routes=planner.routes,
       best_return=best, nominal_return=nominal,
       from_gradient=[bool(i["from_gradient"]) for i in infos],
       poisoned_per_iteration=poisoned, card=card)
  assert launches == dict(rollout=2 * SG_ITERATIONS, riccati=0, scoring=0,
                          cholesky=0), launches

  # (c) robust sampling on Swimmer at the task's own configuration: the K
  # clean candidates on the rollout kernel (cost sums, fluid), the N x M
  # noisy re-rolls on the pipeline physics (batched Cholesky kernel at every
  # solve, fused scoring kernel for the returns)
  planner = robust.RobustPlanner(swim, device=device)
  rcfg = planner.r_config
  assert planner.routes == dict(
      clean_rollouts="rollout_kernel", clean_scoring="rollout_kernel",
      noisy_rollouts="pipeline", noisy_scoring="kernel",
      spd_solve="kernel"), planner.routes
  d0_s = swim.make_data()
  # the last (untimed, uncounted) iteration captures the fused scoring
  # launch and every 100th Cholesky launch, to hold both kernels against
  # their plain versions on the robust path's own inputs below
  captured = dict(score=[], chol=[], chol_calls=0)
  launch_score, launch_chol = scoring._launch, cholesky._launch

  def capture_score(res, cs):
    captured["score"].append((res.clone(), cs))
    return launch_score(res, cs)

  def capture_chol(a, b):
    if captured["chol_calls"] % 100 == 0:
      captured["chol"].append((a.clone(), b.clone()))
    captured["chol_calls"] += 1
    return launch_chol(a, b)

  @contextlib.contextmanager
  def capturing():
    scoring._launch, cholesky._launch = capture_score, capture_chol
    try:
      yield
    finally:
      scoring._launch, cholesky._launch = launch_score, launch_chol

  infos, robust_ms, launches, syncs = run_path(
      planner, d0_s, ROBUST_ITERATIONS, counters, gen, around_last=capturing)
  # the winner is the most robust of the top N, not the clean argmin
  best, nominal, _ = sampling_checks(infos, lambda i: i["returns"][0],
                                     best_is_min=False)
  n_flat = rcfg.num_candidates * rcfg.num_repetitions
  noisy_poisoned = [int((i["noisy_returns"] >= 1e6).sum()) for i in infos]
  path_launches["robust_path"] = launches
  chol_per_iteration = launches["cholesky"] / ROBUST_ITERATIONS
  emit("robust_path", task="Swimmer", K=swim_cfg.num_trajectory,
       H=swim_cfg.horizon, P=swim_cfg.num_spline_points,
       N=rcfg.num_candidates, M=rcfg.num_repetitions,
       xfrc_std=rcfg.xfrc_std, xfrc_rate=rcfg.xfrc_rate,
       iterations=ROBUST_ITERATIONS, ms_per_iteration=robust_ms,
       launches=launches, cholesky_launches_per_iteration=chol_per_iteration,
       host_syncs_per_iteration=syncs, routes=planner.routes,
       best_return=best, nominal_return=nominal,
       robust_return=[float(i["robust_return"]) for i in infos],
       noisy_rerolls=n_flat, noisy_poisoned_per_iteration=noisy_poisoned,
       card=card)
  assert launches["rollout"] == ROBUST_ITERATIONS, launches
  assert launches["scoring"] == ROBUST_ITERATIONS, launches
  assert launches["riccati"] == 0, launches
  assert chol_per_iteration >= 1 and chol_per_iteration == int(
      chol_per_iteration), launches

  # the fused scoring and Cholesky kernels on the robust path's own inputs:
  # first those of the iteration above, at the task's wrench noise, where
  # most re-rolls blow up (as they do in the JAX package); then those of one
  # iteration at a wrench noise the re-rolls survive, so that both kernels
  # are held on sane inputs of the same path over the whole horizon
  def robust_inputs_check(batch, min_prefix, min_sane, elementwise):
    assert len(captured["score"]) == 1 and captured["chol"], captured
    res, cs = captured["score"][0]
    # rows of a rollout that is blowing up overflow float32 in their squares
    # (both versions then give inf, whose difference is NaN): compare the
    # candidates whose rows stay sane, and every candidate over the steps
    # before the first row that is not
    sane = (torch.isfinite(res) & (res.abs() < 1e6)).all(dim=1)   # (T, K)
    alive = sane.all(dim=0)
    bad_steps = torch.nonzero(~sane.all(dim=1))
    prefix = int(bad_steps.min()) if len(bad_steps) else res.shape[0]
    # the scorer got the pipeline rollouts' (K, T, nr) batch as a permuted
    # view (row stride 1), which the kernel reads through its strides: each
    # case is held in that layout and as (T, nr, K) rows
    assert res.stride(1) == 1 and not res.is_contiguous(), res.stride()
    cases = [("sane_candidates", res.permute(2, 0, 1)[alive].permute(
        1, 2, 0))] if bool(alive.any()) else []
    cases.append(("sane_prefix", res[:prefix]))
    score_path = []
    for what, view in cases:
      for layout_name, rows in (("batch (K, T, nr) permuted", view),
                                ("rows (T, nr, K)", view.contiguous())):
        got = scoring._launch(rows, cs)
        want = scoring.score_reference(rows.permute(2, 0, 1), cs)
        torch.cuda.synchronize()
        score_path.append(dict(
            rows=what, residuals=layout_name, strides=list(rows.stride()),
            T=rows.shape[0], K=rows.shape[2],
            max_abs_err=float((got - want).abs().max()),
            within_tol=bool(((got - want).abs() <= TOL_SCORE +
                             TOL_SCORE * want.abs()).all())))
    chol_path = []
    for a, b in captured["chol"]:
      # the systems of candidates whose rollout is still finite
      ok = torch.isfinite(a).all(dim=0).all(dim=0) & \
          torch.isfinite(b).all(dim=0)
      if not bool(ok.any()):
        continue
      a, b = a[:, :, ok].contiguous(), b[:, ok].contiguous()
      x = cholesky._launch(a, b)
      xp = cholesky.chol_solve_lanes_plain(a, b)
      torch.cuda.synchronize()
      # relative to each system's solution: the systems of rollouts that
      # are blowing up are ill conditioned (|x| up to 1e16 seen), and a
      # backward-stable float32 solve is accurate relative to |x| there
      err_col = (x - xp).abs().amax(dim=0) / (1.0 + xp.abs().amax(dim=0))
      chol_path.append(dict(
          n=a.shape[0], K=a.shape[2], max_abs_err=float((x - xp).abs().max()),
          max_abs_x=float(xp.abs().max()),
          max_err_rel_to_solution=float(err_col.max()),
          elementwise_within_tol=bool(((x - xp).abs() <= TOL_CHOL +
                                       TOL_CHOL * xp.abs()).all()),
          within_tol=bool((err_col <= TOL_CHOL).all())))
    emit("robust_path", case="kernels_on_the_planners_inputs", batch=batch,
         residual_batch=dict(T=res.shape[0], nr=res.shape[1],
                             K=res.shape[2], sane_candidates=int(alive.sum()),
                             sane_prefix_steps=prefix),
         score_fused=score_path, cholesky_launches=captured["chol_calls"],
         chol_solve_lanes_checked=len(chol_path),
         chol_solve_lanes_max_abs_err=max(c["max_abs_err"] for c in chol_path),
         chol_solve_lanes_max_err_rel_to_solution=max(
             c["max_err_rel_to_solution"] for c in chol_path),
         chol_solve_lanes_elementwise_within_tol=sum(
             c["elementwise_within_tol"] for c in chol_path),
         chol_solve_lanes_cases=chol_path, tol_score=TOL_SCORE,
         tol_chol=TOL_CHOL, min_sane_prefix_steps=min_prefix,
         min_sane_candidates=min_sane, chol_elementwise=elementwise)
    assert prefix >= min_prefix and int(alive.sum()) >= min_sane, \
        (prefix, int(alive.sum()))
    assert all(c["within_tol"] for c in score_path), score_path
    key = "elementwise_within_tol" if elementwise else "within_tol"
    assert len(chol_path) >= 5 and all(c[key] for c in chol_path), chol_path
    return (max(c["max_abs_err"] for c in score_path),
            max(c["max_abs_err"] for c in chol_path))

  # at the task's noise the re-rolls blow up from step ~20 on (the JAX
  # package alike, tests/robust_divergence_reading.py): the sane prefix is
  # held to a length that still spans many steps
  err_score = max(err_score, robust_inputs_check(
      dict(xfrc_std=rcfg.xfrc_std, iteration="last of run_path"),
      min_prefix=ROBUST_MIN_PREFIX, min_sane=0, elementwise=False)[0])
  sane_cfg = dataclasses.replace(rcfg, xfrc_std=ROBUST_SANE_XFRC)
  sane_planner = robust.RobustPlanner(swim, r_config=sane_cfg, device=device)
  captured.update(score=[], chol=[], chol_calls=0)
  with capturing():
    info = sane_planner.optimize(gen, d0_s)
    torch.cuda.synchronize()
  sane_poisoned = int((info["noisy_returns"] >= 1e6).sum())
  sane_score_err, sane_chol_err = robust_inputs_check(
      dict(xfrc_std=ROBUST_SANE_XFRC, iteration="one, fresh planner",
           noisy_poisoned=sane_poisoned),
      min_prefix=ROBUST_MIN_PREFIX, min_sane=n_flat - ROBUST_SANE_SLACK,
      elementwise=True)
  err_score = max(err_score, sane_score_err)
  err_chol = max(err_chol, sane_chol_err)

  # (d) iLQS on Swimmer: the lane sampler at the task's configuration, then
  # iLQG at the sampler's horizon (201) with the feedback rollouts and the
  # Riccati kernel
  planner = ilqs.ILQSPlanner(swim, device=device)
  assert planner.routes == dict(
      sampler="lane", sampler_rollouts="rollout_kernel",
      sampler_scoring="rollout_kernel", ilqg_line_search="kernel",
      ilqg_backward="kernel"), planner.routes
  infos, ilqs_ms, launches, syncs = run_path(
      planner, d0_s, ILQS_ITERATIONS, counters, gen)
  path_launches["ilqs_path"] = launches
  readbacks = [i["host_readbacks"] for i in infos]
  emit("ilqs_path", task="Swimmer", H=swim_cfg.horizon,
       K=swim_cfg.num_trajectory, iterations=ILQS_ITERATIONS,
       ms_per_iteration=ilqs_ms, launches=launches,
       host_readbacks_per_iteration=readbacks,
       host_syncs_per_iteration=syncs, routes=planner.routes,
       best_return=[i["best_return"] for i in infos],
       sampling_return=[i["sampling_return"] for i in infos],
       ilqg_return=[i["ilqg_return"] for i in infos],
       active=[i["active"] for i in infos], card=card)
  assert launches["rollout"] == 3 * ILQS_ITERATIONS, launches
  assert launches["riccati"] >= ILQS_ITERATIONS, launches
  assert launches["scoring"] == 0 and launches["cholesky"] == 0, launches
  assert all(np.isfinite(i["best_return"]) and i["best_return"] < 1e6
             for i in infos), infos

  # (e) the lane planner on Cartpole (no in-kernel residual): the rollout
  # kernel records states, the task maps them to residual rows, the fused
  # scoring kernel makes the returns
  planner = sampling_lane.LaneSamplingPlanner(cart, device=device)
  assert planner.routes == dict(rollouts="rollout_kernel",
                                scoring="kernel"), planner.routes
  infos, cart_ms, launches, syncs = run_path(
      planner, cart.make_data(), CARTPOLE_ITERATIONS, counters, gen)
  best, nominal, poisoned = sampling_checks(
      infos, lambda i: i["nominal_return"])
  path_launches["cartpole_sampling_path"] = launches
  emit("cartpole_sampling_path", task="Cartpole", K=cart_cfg.num_trajectory,
       H=cart_cfg.horizon, P=cart_cfg.num_spline_points,
       iterations=CARTPOLE_ITERATIONS, ms_per_iteration=cart_ms,
       launches=launches, host_syncs_per_iteration=syncs,
       routes=planner.routes, best_return=best, nominal_return=nominal,
       card=card)
  assert launches == dict(rollout=CARTPOLE_ITERATIONS, riccati=0,
                          scoring=CARTPOLE_ITERATIONS, cholesky=0), launches
  for i in range(1, CARTPOLE_ITERATIONS):
    assert nominal[i] <= nominal[i - 1] * (1 + 1e-6), (i, nominal)

  # ---- 7. ground contacts, site transmission, per-step aux rows ----
  slice_e_entries = ground_site_aux(e_tasks, kernels, counters, card, device)

  # ---- 8. body-body contact pairs ----
  slice_f_entries = body_pairs(f_tasks, kernels, f_models, counters, card,
                               device)

  # ---- 9. summary lines ----
  csrc = "mujoco_mpc_tpu_torch/ops/csrc/"
  print(json.dumps({"kernels": [{
      "name": "step_lane.rollout",
      "route": "cuda",
      "source": csrc + "lane_rollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/step_lane.py:184",
      "launches": main_launches,
      "launches_by_path": dict(
          main_path=main_launches,
          **{k: v["rollout"] for k, v in path_launches.items()}),
      "max_abs_err": err_ret,
      "ms": kernel_ms,
      "plain_ms": plain_ms,
      "bound_ms": bound_ms,
      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      "library_ms": None,
      "layout": b1_layout(kernels["quadruped_cost_sums"], K_MAIN),
  }, {
      "name": "step_lane.rollout[feedback]",
      "route": "cuda",
      "source": csrc + "lane_rollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/step_lane.py:184",
      "launches": lane_launches,
      "max_abs_err": err_fb,
      "ms": fb_ms8,
      "plain_ms": fb_plain_ms,
      "bound_ms": max(fb_bytes_ms, fb_ops_ms),
      "bound_by": "bytes" if fb_bytes_ms >= fb_ops_ms else "operations",
      "library_ms": None,
      "layout": b1_layout(kernels["swimmer_feedback"], 8),
  }, {
      "name": "riccati_lane.backward",
      "route": "cuda",
      "source": csrc + "riccati_backward.cu",
      "replaces": "mujoco_mpc_tpu/ops/riccati_lane.py:58",
      "launches": riccati_launches,
      "launches_by_path": dict(
          ilqg_path=riccati_launches,
          **{k: v["riccati"] for k, v in path_launches.items()
             if v["riccati"]}),
      "max_abs_err": err_riccati,
      "ms": riccati_ms,
      "plain_ms": riccati_plain_ms,
      "bound_ms": max(riccati_bytes_ms, riccati_ops_ms),
      "bound_by": "bytes" if riccati_bytes_ms >= riccati_ops_ms
                  else "operations",
      "library_ms": None,
  }, {
      "name": "scoring.score_fused",
      "route": "cuda",
      "source": csrc + "score_fused.cu",
      "replaces": "mujoco_mpc_tpu/ops/scoring.py:47",
      "launches": sum(v["scoring"] for v in path_launches.values()),
      "launches_by_path": {k: v["scoring"] for k, v in path_launches.items()
                           if v["scoring"]},
      "max_abs_err": err_score,
      "ms": score_main["kernel_ms"],
      "plain_ms": score_main["plain_ms"],
      "bound_ms": max(score_main["bytes_ms"], score_main["ops_ms"]),
      "bound_by": "bytes" if score_main["bytes_ms"] >= score_main["ops_ms"]
                  else "operations",
      "library_ms": None,
      "device_ms": score_main["device_ms"],
      "layout": score_main["layout"],
      "path_shapes": [dict((key, r[key]) for key in (
          "task", "K", "T", "residuals", "layout", "device_kernels",
          "device_ms", "kernel_ms", "bytes_ms", "max_abs_err"))
          for r in score_rows if r["K"] != K_MAIN],
  }, {
      "name": "cholesky.chol_solve_lanes",
      "route": "cuda",
      "source": csrc + "chol_solve_lanes.cu",
      "replaces": "mujoco_mpc_tpu/ops/cholesky.py:66",
      "launches": sum(v["cholesky"] for v in path_launches.values()),
      "launches_by_path": {k: v["cholesky"] for k, v in path_launches.items()
                           if v["cholesky"]},
      "max_abs_err": err_chol,
      "ms": chol_main["kernel_ms"],
      "plain_ms": chol_main["plain_ms"],
      "bound_ms": max(chol_main["bytes_ms"], chol_main["ops_ms"]),
      "bound_by": "bytes" if chol_main["bytes_ms"] >= chol_main["ops_ms"]
                  else "operations",
      "library_ms": chol_main["library_ms"],
      "device_ms": chol_main["device_ms"],
      "layout": chol_main["layout"],
  }] + slice_e_entries + slice_f_entries}), flush=True)
  print(card, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
