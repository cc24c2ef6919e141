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
  9. after phases 10, 11 and 12, prints one JSON line describing every kernel
     (the rollout kernel by build: main path, feedback, humanoid track,
     humanoid stand, site, rubik, cube solving, hand reorient, the agent
     paths' cartpole states, swimmer cost sums and swimmer feedback at
     H=201, walker feedback and walker cost sums; B2, B3 and B4 also at
     phase 11's new sizes; and
     the checks-only builds rubik box-box and rubik elliptic with
     `on_path: false`; each kernel's launches by path; each rollout build
     with its `layout`: lanes a team, teams a block, shared memory, where
     its contact tables live, workspace, ptxas lines), the card line, and
     `{"ok": true, ...}` as the last line;
 10. `agent_paths` — the agent loop through the entry points a user calls:
     `agent_cartpole` (`testspeed.run("Cartpole", total_time=10)`, seeds
     0-2: the lane planner, B1 states then B3, one launch of each a plan;
     the cost over the last simulated second below the first's on each
     seed and below half of it over the seeds),
     `agent_swimmer` (`testspeed.run("Swimmer", total_time=2)`: B1 cost
     sums with fluid; the nose closer to the target at the end), each with
     plan latency p50/p90, realtime factor, step_env ms (a CUDA graph of
     the pipeline step, checked against the eager step, whose time is also
     printed) and host synchronisations a plan and a step;
     `agent_swimmer_ilqg` (iLQG under the Agent at H=201, 5 plans, 4 steps
     after each: B1 feedback and B2, the feedback term non-zero);
     `agent_runner_flagship` (AgentRunner on the main path's planner, the
     control thread setting the state and reading actions at ~1 kHz for
     ~3 s: plan iterations a second, the policy version, action()
     latency); the rollout builds these paths launch that no earlier case
     holds are held to their plain versions on each path's own last
     launch (`agent_cartpole_states`, `agent_swimmer_cost_sums`,
     `agent_swimmer_feedback`). `python3 chip_smoke.py --only agent_paths`
     runs this phase alone;
 11. `contact_gradient_paths` — pipeline contacts and the Gradient planner:
     `gradient_path` (`make_planner(Swimmer, "Gradient")` at its own
     configuration, H=201: the forward step, the reverse step's
     vector-Jacobian product and the line search's batched step each
     replayed from a CUDA graph; 1 warm-up and 3 chained iterations, stage
     times, host syncs, B3 and B4 launches (B4's counted on the device
     at each replay); B3 and B4 held against their plain versions on the
     line search's own inputs; the graph route against the same step
     functions run uncaptured at H=21), `walker_ilqg_path` (BASELINE
     config 2b: iLQG on Walker at H=32, derivatives through the contact
     rows, 1 warm-up and 5 chained iterations; B2 on every sweep of one
     more iteration and B1 feedback on its last launch held against their
     plain versions, B1 feedback once more from a pressed state; B2 timed
     at Walker's size) and `agent_walker` (`testspeed.run("Walker",
     total_time=2)`: the lane sampler at K=32, H=81, the contact step graph
     against the eager step, the torso above the floor; the cost-sums
     build held on the path's last launch, per candidate beside the nudged
     plain witness, and its states build step by step over the horizon).
     `python3 chip_smoke.py --only contact_gradient_paths` runs this phase
     alone;
 12. `estimator_paths` — the estimators and the Direct optimizer on
     Cartpole: `agent_cartpole_ekf` and `agent_cartpole_ukf` (the loop of
     tests/test_agent_estimator.py: `Agent(Cartpole, "Sampling",
     estimator=..., sensor_noise=0.01)`, 500 steps, two plans every 4
     steps; the estimation error's mean over the last 50 steps below 0.3,
     the pole's Vertical residual below 1.2 in size; each filter update
     one CUDA graph, the UKF's sigma points stepped with B4 at (2, 9);
     after the loop 10 updates timed on the host clock, 10 on the device
     (profiler; CUDA events beside it), the host syncs of one, the
     realtime factor), B1's states build (10, 101) held to its plain
     version on the path's last launch, B3 on the path's last scoring
     inputs, B4 on the UKF graph's own inputs; `batch_cartpole` (the Batch
     estimator at its default window and at 32, filled, then 10 updates
     timed on the host and 10 on the device; the final qpos error below
     0.1) and `direct_cartpole` (Direct at T=32, banded, on a noisy
     recorded window: ms an optimize, iterations, status, the cost before
     and after, asserted lower, and the qpos error under half the noisy
     start's). Batch and Direct run the Gauss-Newton loop on the host: one
     CUDA graph an iteration, replayed while the loop's condition holds,
     which is read back once an iteration (the host syncs printed).
     `python3 chip_smoke.py --only estimator_paths` runs this phase alone.

Any failure raises, so the process exits non-zero. Nothing here imports
JAX or the JAX package.
"""

import contextlib
import dataclasses
import gc
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
# phase 10: the agent loop. testspeed on Cartpole (its own configuration,
# K=10, H=101; 10 simulated seconds, a plan every 4 steps) for three seeds
# and on Swimmer (K=10, H=201; 2 s = 1,000 steps of 0.002 s); iLQG on
# Swimmer under the Agent (H=201), 5 plans with 4 steps after each; the
# flagship under AgentRunner, the control thread at ~1 kHz for ~3 s
AGENT_SEEDS = (0, 1, 2)
AGENT_CARTPOLE_TIME, AGENT_SWIMMER_TIME, AGENT_STEPS_PER_PLAN = 10.0, 2.0, 4
AGENT_ILQG_PLANS = 5
RUNNER_SECONDS, RUNNER_PERIOD_S, RUNNER_MIN_ITERATIONS = 3.0, 1e-3, 50
# the Cartpole cost over the last simulated second must fall below the
# first second's on every seed, and, averaged over the seeds, below this
# share of it. Per seed the share is not held: at K=10 one seed in three
# stays above it in the JAX package too (its agent on the CPU, the pipeline
# planner, seeds 0-2: 0.574, 0.268, 0.186 of the first second's cost;
# `python -m tests.agent_cartpole_reading`).
# The swing-up tail, |cos - 1| over the last 0.5 s, is printed only (K=10
# swings up on some seeds only, tests/test_planner_cartpole.py)
AGENT_COST_DROP = 0.5
# the CUDA graph of one physics step against the eager step, one step from
# the same state
TOL_STEP_GRAPH = 1e-6
# phase 11: the Gradient planner on Swimmer at its own configuration (H=201,
# 10 spline points, 8 line-search candidates), 1 warm-up and 3 chained
# iterations; its graph route against its eager route at H=21 (the same
# kernels in the same order, so only the library routines' choices could
# part them: relative to the eager value); iLQG on Walker at BASELINE
# config 2b (scripts/bench_configs.py:243, H=32), 1 warm-up and 5 chained
# iterations; Walker under the agent (testspeed, 2 simulated seconds, the
# lane sampler at its own configuration K=32, H=81, 3 spline points)
GRADIENT_ITERATIONS, GRADIENT_CHECK_HORIZON = 3, 21
TOL_GRAPH_VS_EAGER = 1e-5
HORIZON_WALKER_ILQG, WALKER_ILQG_ITERATIONS = 32, 5
K_WALKER_AGENT, HORIZON_WALKER_AGENT, AGENT_WALKER_TIME = 32, 81, 2.0
# A contact-rich launch's whole-horizon outcome (Walker's cost sums standing
# under the agent, its feedback rollouts from a pressed state) is held to
# the plain version per candidate. Where the kernel parts from it by more
# than the bar, the plain version from the same start nudged by
# CONTROL_PERTURBATION (relative; WITNESS_NUDGES draws) must part from
# itself on that candidate by at least TOL_WITNESS_RATIO of the kernel's
# gap: the candidate's outcome is then not fixed to the bar by its float32
# inputs (a contact gate flipped by a last-bit difference). Candidates the
# witness does not explain fail the check.
WITNESS_NUDGES = 4
TOL_WITNESS_RATIO = 0.1
# the torso (a capsule of radius 0.07 m) stays above this height (m)
TORSO_FLOOR = 0.03
# phase 12: the filters in the Cartpole agent loop (tests/
# test_agent_estimator.py's loop: 500 steps, two plans every 4 steps,
# sensor noise 0.01), its bars (the estimation error's mean over the last
# 50 steps, the pole's Vertical residual), and the updates timed after it
FILTER_STEPS, FILTER_PLANS, FILTER_TAIL = 500, 2, 50
FILTER_ERR_BAR, VERTICAL_BAR = 0.3, 1.2
TIMED_UPDATES = 10
# Batch at its default window and at BASELINE's 32, filled, then timed
# (TIMED_UPDATES on the host clock, DEVICE_UPDATES on the device: a
# profile of one holds tens of thousands of kernels); Direct at T=32
# (banded); the JAX suite's bars: the Batch qpos error below 0.1 at the
# end, Direct's cost lower and its qpos error under half the noisy start's
BATCH_LENGTHS, BATCH_ERR_BAR, DEVICE_UPDATES = (None, 32), 0.1, 1
DIRECT_HORIZON, DIRECT_NOISE, DIRECT_REPS = 32, 0.05, 5


def emit(phase, **kw):
  print(json.dumps(dict(phase=phase, **kw)), flush=True)


# wall seconds of each phase of a whole run, in the order run
PHASE_SECONDS = {}
_PHASE = [None, time.perf_counter()]


def phase_mark(name):
  """Close the phase running (its wall seconds into PHASE_SECONDS) and
  start `name` (None: none)."""
  now = time.perf_counter()
  if _PHASE[0] is not None:
    PHASE_SECONDS[_PHASE[0]] = round(now - _PHASE[1], 1)
  _PHASE[:] = [name, now]


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


def graph_launch_ms(fn, launches=50, reps=20):
  """Device milliseconds a launch of fn() (one kernel launch a call) takes
  back to back: `launches` calls captured as one CUDA graph, replayed
  `reps` times between CUDA events, so no host launch time is inside (the
  gaps between the graph's kernel nodes are). The wrappers' launch counts
  are left alone: these launches only time the kernel. Taken where
  `device_ms` can read nothing (the profiler has shown no device time late
  in the whole script's run)."""
  from mujoco_mpc_tpu_torch.ops import launches as launch_counts

  count = launch_counts.count
  launch_counts.count = lambda replay_counts, device: 0
  collecting = gc.isenabled()
  try:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()      # a graph collected during a capture invalidates it
    with torch.cuda.graph(graph):
      for _ in range(launches):
        fn()
  finally:
    launch_counts.count = count
    if collecting:
      gc.enable()
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (reps * launches)


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
  zero_counts(counters)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  infos = [planner.optimize(gen, d0) for _ in range(iterations)]
  end.record()
  torch.cuda.synchronize()
  launches = read_counts(counters)
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
                 first=None, steps_as_lanes=False):
  """Each step of a recorded rollout but the last (whose outcome the record
  does not hold; only the steps of `window` = range(start, stop), if given)
  repeated by the plain version from the kernel's own pre-step state, and
  once more from that state nudged by CONTROL_PERTURBATION (relative): per
  (step, candidate) pair, whether the next state is within TOL_STEP_QPOS /
  TOL_STEP_QVEL (absolute), for the kernel and for the control; pairs of
  rollouts that have blown up are left out. `first`, if given, is the plain
  version's state after step 0 from the same initial state (a plain rollout
  of the same inputs), taken in place of repeating that step. Where `rec`
  holds residual rows, the plain version's rows at the kernel's pre-step
  states are held to them too (`max_err_rows_rel`: abs/rel, TOL_ROWS's
  form). With `steps_as_lanes` (a task whose residual reads no step index)
  the plain version takes all the steps in one call, side by side as
  lanes, and once more for the control: the same arithmetic lane by lane,
  without a call's fixed cost a step."""
  horizon, _, k = rec.shape
  nu = values.shape[0] // p
  ts = list(window or range(horizon - 1))

  def ctrl_at(t):
    node = min(int(t * p / max(horizon - 1, 1)), p - 1)
    return values[node * nu:(node + 1) * nu]

  def lanes(parts):
    return torch.cat(parts, dim=1)

  def nudged(x):
    return x * (1.0 + CONTROL_PERTURBATION * torch.randn(
        x.shape, generator=gen, device=x.device))

  if steps_as_lanes:
    assert first is None
    wide = (lanes([ctrl_at(t) for t in ts]),
            0, None if aux is None else aux.repeat(1, len(ts)))
    qps = lanes([rec[t, :nq] for t in ts])
    qvs = lanes([rec[t, nq:nq + nv] for t in ts])
    plain = list(zip(*[o.split(k, dim=1) for o in kern.step_array(
        qps, qvs, *wide)]))
    control = list(zip(*[o.split(k, dim=1) for o in kern.step_array(
        nudged(qps), nudged(qvs), *wide)]))

  def within(a, b):
    return ((a[:nq] - b[:nq]).abs().amax(dim=0) <= TOL_STEP_QPOS) & \
        ((a[nq:] - b[nq:]).abs().amax(dim=0) <= TOL_STEP_QVEL)

  ok_k, ok_c, sane, err_q, err_v, err_rows = [], [], [], [], [], []
  for i, t in enumerate(ts):
    ctrl = ctrl_at(t)
    qp, qv = rec[t, :nq], rec[t, nq:nq + nv]
    if t == 0 and first is not None:
      want = first
    else:
      q_n, v_n, rows = plain[i] if steps_as_lanes else \
          kern.step_array(qp, qv, ctrl, t, aux)
      want = torch.cat([q_n, v_n])
      if rec.shape[1] > nq + nv:
        err_rows.append(float(((rec[t, nq + nv:] - rows).abs() /
                               (1.0 + rows.abs())).max()))
    ctl = torch.cat(control[i][:2] if steps_as_lanes else kern.step_array(
        nudged(qp), nudged(qv), ctrl, t, aux)[:2])
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
  rows = dict(max_err_rows_rel=max(err_rows)) if err_rows else {}
  return dict(pairs=n, left_out_pairs=int((~sane).sum()),
              share_within=share_k, control_share_within=share_c,
              slack=slack, passes=share_k >= share_c - slack,
              median_err_qpos=float(torch.stack(err_q)[sane].median()),
              median_err_qvel=float(torch.stack(err_v)[sane].median()),
              max_err_qpos=float(torch.stack(err_q)[sane].max()),
              max_err_qvel=float(torch.stack(err_v)[sane].max()), **rows)


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


def build_twinned(task, horizon, p, **kw):
  """`step_lane.build_rollout_kernel` of the task's plan model on the card
  with, as its `twin`, the same build of the task's CPU copy (that copy's
  residual spec; the defines asserted equal): a check's plain version runs
  there, on the host's CPU, where its thousands of small operations a step
  take less time than as launches on the card."""
  from mujoco_mpc_tpu_torch.ops import sampling_lane, step_lane
  from mujoco_mpc_tpu_torch.tasks import registry

  kern = step_lane.build_rollout_kernel(
      task.plan_model, horizon, p,
      residual=sampling_lane.lane_residual_spec(task, horizon), **kw)
  cpu = registry.get_task(task.name, device="cpu")
  kern.twin = step_lane.build_rollout_kernel(
      cpu.plan_model, horizon, p,
      residual=sampling_lane.lane_residual_spec(cpu, horizon), **kw)
  assert kern.twin.build_defines() == kern.build_defines(), task.name
  return kern


class OnHost:
  """A twinned build's plain version (`build_twinned`, or a `twin` set
  beside the build) run on the twin, on the host's CPU: the arguments go
  to the host, the results come back to the arguments' device. At K of a
  few hundred its thousands of small operations a step take a quarter to
  a half of the time there that they take as launches on the card (at
  K=4096 the card is the faster)."""

  def __init__(self, kern):
    assert kern.twin.build_defines() == kern.build_defines()
    self.twin = kern.twin

  def _run(self, fn, args):
    dev = next(a.device for a in args if torch.is_tensor(a))
    out = fn(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    if isinstance(out, tuple):
      return tuple(o.to(dev) for o in out)
    return out.to(dev)

  def plain(self, *args):
    return self._run(self.twin.plain, args)

  def step_array(self, *args):
    return self._run(self.twin.step_array, args)

  def residual_array(self, *args):
    return self._run(self.twin.residual_array, args)


def cost_sums_check(kern, task, spec, d0, values, horizon):
  """One cost-sum launch of `kern` from d0's state on every candidate of
  `values`, held against the plain version on the same inputs: the returns
  (weighted term sums over the horizon) within TOL_RETURN_REL but for a
  TOL_RETURN_SHARE of candidates, and the best candidate of each (0 is the
  nominal); the kernel's time (CUDA events), the plain version's (one call
  on the host's CPU from the build's `twin`, host clock) and the bound.
  Returns the row to print, which also keys the build's summary entry."""
  k = values.shape[1]
  terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
  args = (d0.qpos[:, None].repeat(1, k).contiguous(),
          d0.qvel[:, None].repeat(1, k).contiguous(), values,
          lane_aux(task, spec, d0, k, terms))
  sums, fin = kern(*args)
  torch.cuda.synchronize()
  args_c = [a.cpu() for a in args]
  t0 = time.perf_counter()
  sums_p, _ = kern.twin.plain(*args_c)
  plain_ms = (time.perf_counter() - t0) * 1e3
  sums_p = sums_p.to(sums.device)
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
    # every build twinned: the checks run their plain versions on the
    # host's CPU (OnHost)
    kernels[name] = build_twinned(
        task, hor, p, naux=spec["naux"], record_states=states,
        cost_terms=None if states else terms)
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
  row = step_by_step(OnHost(kern), rec, values, aux, p_h, nq, nv, gen,
                     window)
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
  rec_p = OnHost(kern).plain(*q_args)
  torch.cuda.synchronize()
  q_row = step_by_step(OnHost(kern), rec, q_vals, q_aux,
                       q_cfg.num_spline_points, qm.nq, qm.nv, gen)
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
    kernels[f"{key}_cost_sums"] = build_twinned(
        task, HORIZON_BODY, p, naux=spec["naux"], record_states=False,
        cost_terms=terms, **select)
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
    # each states build's CPU twin: the same build of the task's CPU copy,
    # its model changed the same way (OnHost runs the checks there)
    cpu = registry.get_task(task.name, device="cpu")
    cm = cpu.plan_model
    twin_models = {key: cm}
    if key == "rubik":
      csize = cm.geom_size.clone()
      csize[knobs] = BOXBOX_KNOB_HALF
      twin_models = {"rubik_boxbox": cm.replace(geom_size=csize),
                     "rubik_elliptic": cm.replace(opt=cm.opt.replace(
                         cone=1, impratio=torch.tensor(10.0)))}
    cspec = cpu.lane_residual_spec()
    for name, model, select_, horizon in variants:
      models[name] = (task, model, select_)
      kern = step_lane.build_rollout_kernel(
          model, horizon, p, residual=spec, naux=spec["naux"],
          record_states=True, **select_)
      kern.twin = step_lane.build_rollout_kernel(
          twin_models[name], horizon, p, residual=cspec,
          naux=cspec["naux"], record_states=True, **select_)
      assert kern.twin.build_defines() == kern.build_defines(), name
      kernels[f"{name}_states"] = kern
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
  host = OnHost(kern)
  t0 = time.perf_counter()
  rec_p = host.plain(*args)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  rows_p = []
  for t in range(horizon):
    node = min(int(t * p / max(horizon - 1, 1)), p - 1)
    rows_p.append(host.residual_array(rec[t, :nq], rec[t, nq:nq + nv],
                                      values[node * nu:(node + 1) * nu], t,
                                      aux))
  torch.cuda.synchronize()
  rows_ms = (time.perf_counter() - t0) * 1e3
  cs = task.cost_spec
  ret = cs.cost(rec[:, nq + nv:].movedim(1, -1)).mean(dim=0)
  ret_p = cs.cost(torch.stack(rows_p).movedim(1, -1)).mean(dim=0)
  ok = torch.isfinite(ret) & torch.isfinite(ret_p)
  rel = ((ret - ret_p).abs() / torch.clamp(ret_p.abs(), min=1.0))[ok]
  steps = step_by_step(host, rec, values, aux, p, nq, nv, gen,
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
             plain_on="cpu", bytes=nb, flops=nf, bytes_ms=bytes_ms,
             ops_ms=ops_ms, active_rows=rows, touching_candidates=touching,
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


@contextlib.contextmanager
def recording_rollouts(records):
  """Inside the block every rollout-kernel build records its build's
  arguments and the arguments of its last launch in `records` under its
  library path (the hash of its defines); the launch itself is the
  kernel's own."""
  from mujoco_mpc_tpu_torch.ops import _build, step_lane

  build = step_lane.build_rollout_kernel

  def build_recorded(*a, **kw):
    kern = build(*a, **kw)
    path = _build.library_path("lane_rollout.cu", kern.build_defines())[0]

    def rollout(*args, **kwargs):
      records[path] = (kern, (a, kw), args, kwargs)
      return kern(*args, **kwargs)

    rollout.__dict__.update(kern.__dict__)
    return rollout

  step_lane.build_rollout_kernel = build_recorded
  try:
    yield records
  finally:
    step_lane.build_rollout_kernel = build


def recorded_check(name, recorded, task, card, witness=False):
  """A path's own last launch of a rollout build, repeated, against the
  plain version on the same inputs: every recorded state (states and
  feedback modes) to the states tolerance, or the returns (cost-sum mode)
  per share of candidates. The plain version runs on the host's CPU, from
  the same build made of the task's CPU twin (its defines asserted equal
  to the card's build): its thousands of small ops a step take about half
  the time there that they take as launches on the card. Returns the row
  for the build's summary entry (time, plain time, bound: one step's
  operations of one candidate times the steps and the candidates; the
  feedback law's 2 nu ndx a step not counted). With `witness` (a
  contact-rich states or feedback launch) a candidate whose states part
  from the plain version's by more than the bar passes where the nudged
  plain witness explains the gap (`witness_check`)."""
  from mujoco_mpc_tpu_torch.ops import sampling_lane, step_lane
  from mujoco_mpc_tpu_torch.tasks import registry

  kern, (build_a, build_kw), args, kwargs = recorded
  defs = kern.build_defines()
  horizon, nu = defs["LR_H"], defs["LR_NU"]
  twin_task = registry.get_task(task.name, device="cpu")
  twin_kw = dict(build_kw)
  if twin_kw.get("residual") is not None:
    twin_kw["residual"] = sampling_lane.lane_residual_spec(twin_task,
                                                           horizon)
  twin = step_lane.build_rollout_kernel(twin_task.plan_model, *build_a[1:],
                                        **twin_kw)
  assert twin.build_defines() == defs, "the CPU twin is another build"
  k = args[0].shape[1]
  got = kern(*args, **kwargs)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  want = twin.plain(*[a.cpu() for a in args],
                    **{key: v.cpu() for key, v in kwargs.items()})
  plain_ms = (time.perf_counter() - t0) * 1e3
  dev = args[0].device
  want = tuple(w.to(dev) for w in want) if isinstance(want, tuple) \
      else want.to(dev)
  outs = got if isinstance(got, tuple) else (got,)
  row = dict(K=k, H=horizon, mode=kern.mode, feedback=bool(defs["LR_CTRL"]),
             kernel_ms=time_cuda(lambda: kern(*args, **kwargs), 10),
             plain_ms=plain_ms, plain_on="cpu")
  if kern.mode == step_lane.MODE_COST_SUMS:
    w = task.cost_spec.weights[:, None]
    ret = (w * got[0]).sum(dim=0) / horizon
    ret_p = (w * want[0]).sum(dim=0) / horizon
    rel = (ret - ret_p).abs() / torch.clamp(ret_p.abs(), min=1.0)
    row.update(max_abs_err_return=float((ret - ret_p).abs().max()),
               max_rel=float(rel.max()),
               share_over_tol=float((rel > TOL_RETURN_REL).float().mean()),
               tol_return_rel=TOL_RETURN_REL, tol_share=TOL_RETURN_SHARE)
    ok = bool(torch.isfinite(ret).all()) and \
        row["share_over_tol"] <= TOL_RETURN_SHARE
  else:
    tol = TOL_STATES_CARTPOLE if task.name == "Cartpole" \
        else TOL_STATES_SWIMMER
    err = float((got - want).abs().max())
    # Walker falls from 2.6 m at its start (config 2b): its recorded states
    # reach |x| ~ 4 over the 32 steps, so its bar is abs/rel (TOL_STEP's
    # form); Cartpole's and Swimmer's stay absolute
    scale = 1.0 + want.abs() if task.name == "Walker" else 1.0
    err_scaled = float(((got - want).abs() / scale).max())
    row.update(max_abs_err_return=err, max_abs_err_states=err,
               max_err_states_abs_rel=err_scaled, tol=tol,
               tol_form="abs/rel" if task.name == "Walker" else "abs")
    ok = bool(torch.isfinite(got).all()) and err_scaled <= tol
    if witness:
      # per candidate, over every recorded state
      want_c = want.cpu()

      def per_candidate(x):
        return ((x - want_c).abs() / (1.0 + want_c.abs())).amax(dim=(0, 1))

      nudged = nudged_plain(
          twin, [a.cpu() for a in args],
          {key: v.cpu() for key, v in kwargs.items()},
          torch.Generator().manual_seed(SEED + 2))
      err_w = torch.stack([per_candidate(o[0]) for o in nudged]).amax(dim=0)
      fields, ok_w = witness_check(per_candidate(got.cpu()), err_w, tol)
      row.update(per_candidate=fields)
      ok = bool(torch.isfinite(got).all()) and ok_w
  one = [a[:, :1].cpu() for a in args[:2]]
  aux = args[3][:, :1].cpu() if len(args) > 3 else None
  ctrl = torch.zeros((nu, 1))
  flops = count_flops(lambda: kern.step_array(*one, ctrl, 0, aux)) \
      * horizon * k
  nbytes = 4 * (sum(int(a.numel()) for a in args if torch.is_tensor(a)) +
                sum(int(v.numel()) for v in kwargs.values()
                    if torch.is_tensor(v)) +
                sum(int(o.numel()) for o in outs))
  row.update(bytes=nbytes, flops=flops,
             bytes_ms=nbytes / H100_BYTES_PER_S * 1e3,
             ops_ms=flops / H100_F32_FLOPS * 1e3)
  emit("kernels", case=name, card=card, **row)
  assert ok, row
  return row


def zero_counts(counters):
  """Every kernel wrapper's launch count to 0: the eager launches on the
  host and the tallies graph replays add on the device."""
  from mujoco_mpc_tpu_torch.ops import launches

  for mod in counters.values():
    mod.launch_count = 0
    launches.zero(mod.replay_counts)


def read_counts(counters):
  """Each kernel's launches since `zero_counts`, eager and replayed from a
  CUDA graph (read back from the device)."""
  from mujoco_mpc_tpu_torch.ops import launches

  return {name: mod.launch_count + launches.replays(mod.replay_counts)
          for name, mod in counters.items()}


def agent_syncs(agent, steps_per_plan):
  """Synchronising calls of one plan iteration, and of one loop step of
  `run` (step_env and the step's read of its cost, action and state), the
  agent's graph captured and its kernels loaded before."""
  agent.plan_iteration()
  agent.step_env()
  torch.cuda.synchronize()
  _, plan = count_syncs(agent.plan_iteration)
  dt = agent.timestep
  # one plan and steps_per_plan steps, the plan not waited for
  _, loop = count_syncs(lambda: agent.run(
      steps_per_plan * dt, steps_per_plan, pipelined_plan=True))
  return plan, (loop - plan) / steps_per_plan


def graph_and_eager_step_ms(agent, steps=5):
  """Milliseconds of one step of the pipeline physics as the agent's CUDA
  graph and run eagerly (the route the graph replaces), each up to a
  synchronise, and the largest difference of the graph's step from the
  eager one from the same state."""
  from mujoco_mpc_tpu_torch.physics import forward as F

  d = agent.data
  eager = F.step(agent.m, d)
  graph = agent._step(d)
  torch.cuda.synchronize()
  err = max(float((getattr(eager, f) - getattr(graph, f)).abs().max())
            for f in ("qpos", "qvel", "time"))
  out = []
  for step in (agent._step, lambda d: F.step(agent.m, d)):
    d = agent.data
    t0 = time.perf_counter()
    for _ in range(steps):
      d = step(d)
    torch.cuda.synchronize()
    out.append((time.perf_counter() - t0) * 1e3 / steps)
  return out[0], out[1], err


def agent_paths(counters, path_launches, card, device, main_ms=None):
  """Phase 10: the agent loop through its entry points (testspeed, Agent,
  AgentRunner) on the card. Adds each path's launches to `path_launches`
  and returns the summary entries of the rollout builds the paths launch
  that no earlier case holds to their plain versions (held here on the
  paths' own last launches)."""
  from mujoco_mpc_tpu_torch import testspeed
  from mujoco_mpc_tpu_torch.agent.agent import Agent
  from mujoco_mpc_tpu_torch.agent.runner import AgentRunner
  from mujoco_mpc_tpu_torch.ops import sampling_lane
  from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
  from mujoco_mpc_tpu_torch.planners import sampling
  from mujoco_mpc_tpu_torch.spline import Interpolation
  from mujoco_mpc_tpu_torch.tasks import registry

  entries, records = [], {}
  t_phase = time.perf_counter()

  def testspeed_path(task_name, total_time, seed):
    zero_counts(counters)
    out = testspeed.run(task_name, total_time=total_time,
                        steps_per_planning_iteration=AGENT_STEPS_PER_PLAN,
                        verbose=False, device=device, seed=seed)
    launches = read_counts(counters)
    run = out["run"]
    plans = len(run["plan_times"])
    stats = dict(plans=plans, launches=launches,
                 launches_per_plan={k: v / (plans + 1)
                                    for k, v in launches.items()},
                 plan_ms_p50=out["plan_time_p50"] * 1e3,
                 plan_ms_p90=out["plan_time_p90"] * 1e3,
                 realtime_factor=out["realtime_factor"],
                 step_ms_mean=out["step_time_mean"] * 1e3,
                 wall_s=out["wall_time"], avg_cost=out["avg_cost"],
                 routes=out["routes"])
    return out, run, stats

  # (a) Cartpole: the lane planner's residual-from-states branch (B1
  # states, then B3), three seeds
  cart = registry.get_task("Cartpole", device=device)
  steps_per_s = int(round(1.0 / float(cart.model.opt.timestep)))
  cart_launches = dict.fromkeys(counters, 0)
  cost_drop = []
  for seed in AGENT_SEEDS:
    rec = {} if seed else records
    with recording_rollouts(rec):
      out, run, stats = testspeed_path("Cartpole", AGENT_CARTPOLE_TIME,
                                       seed)
    first = float(run["costs"][:steps_per_s].mean())
    last = float(run["costs"][-steps_per_s:].mean())
    tail = float(np.abs(np.cos(run["states"][-steps_per_s // 2:, 1])
                        - 1.0).mean())
    emit("agent_cartpole", seed=seed, K=10, H=101, card=card,
         cost_first_second=first, cost_last_second=last,
         swing_up_tail=tail, **stats)
    assert out["routes"] == dict(
        planner="LaneSamplingPlanner", lane_eligible=True,
        lane_reason="eligible", rollouts="rollout_kernel",
        scoring="kernel"), out["routes"]
    plans = stats["plans"]
    assert stats["launches"] == dict(rollout=plans + 1, riccati=0,
                                     scoring=plans + 1, cholesky=0), stats
    assert np.isfinite(run["costs"]).all() and last < first, (first, last)
    cost_drop.append((first, last))
    for k, v in stats["launches"].items():
      cart_launches[k] += v
  path_launches["agent_cartpole"] = cart_launches
  first, last = np.mean(cost_drop, axis=0)
  emit("agent_cartpole", case="cost_over_seeds", seeds=list(AGENT_SEEDS),
       cost_first_second_mean=first, cost_last_second_mean=last,
       share=last / first, max_share=AGENT_COST_DROP, card=card)
  assert last < AGENT_COST_DROP * first, (first, last)
  agent = Agent(cart)
  plan_syncs, step_syncs = agent_syncs(agent, AGENT_STEPS_PER_PLAN)
  graph_ms, eager_ms, graph_err = graph_and_eager_step_ms(agent)
  emit("agent_cartpole", case="syncs_and_step",
       host_syncs_per_plan=plan_syncs, host_syncs_per_step=step_syncs,
       graph_step_ms=graph_ms, eager_step_ms=eager_ms,
       graph_vs_eager_max_abs_err=graph_err,
       tol=TOL_STEP_GRAPH, card=card)
  assert plan_syncs == 0 and graph_err <= TOL_STEP_GRAPH, \
      (plan_syncs, graph_err)
  (recorded,) = records.values()
  kern = recorded[0]
  row = recorded_check("agent_cartpole_states", recorded, cart, card)
  entries.append(rollout_entry(
      "cartpole_states", row, "agent_cartpole",
      dict(agent_cartpole=cart_launches["rollout"]),
      layout=b1_layout(kern, row["K"])))
  # the same build is the cartpole_sampling_path's
  if "cartpole_sampling_path" in path_launches:
    entries[-1]["launches_by_path"]["cartpole_sampling_path"] = \
        path_launches["cartpole_sampling_path"]["rollout"]

  # (b) Swimmer: the in-kernel residual, B1 cost sums with fluid
  records.clear()
  with recording_rollouts(records):
    out, run, stats = testspeed_path("Swimmer", AGENT_SWIMMER_TIME, 0)
  path_launches["agent_swimmer"] = stats["launches"]
  swim = registry.get_task("Swimmer", device=device)
  target = swim.make_data().mocap_pos[0, :2].cpu().numpy()
  dist = np.linalg.norm(run["states"][:, :2] - target, axis=1)
  agent = Agent(swim)
  plan_syncs, step_syncs = agent_syncs(agent, AGENT_STEPS_PER_PLAN)
  graph_ms, eager_ms, graph_err = graph_and_eager_step_ms(agent)
  emit("agent_swimmer", K=10, H=201, card=card,
       nose_target_distance_first=float(dist[0]),
       nose_target_distance_last=float(dist[-1]),
       host_syncs_per_plan=plan_syncs, host_syncs_per_step=step_syncs,
       graph_step_ms=graph_ms, eager_step_ms=eager_ms,
       graph_vs_eager_max_abs_err=graph_err, **stats)
  assert out["routes"] == dict(
      planner="LaneSamplingPlanner", lane_eligible=True,
      lane_reason="eligible", rollouts="rollout_kernel",
      scoring="rollout_kernel"), out["routes"]
  plans = stats["plans"]
  assert stats["launches"] == dict(rollout=plans + 1, riccati=0, scoring=0,
                                   cholesky=0), stats
  assert np.isfinite(run["costs"]).all() and dist[-1] < dist[0], \
      (dist[0], dist[-1])
  assert plan_syncs == 0 and graph_err <= TOL_STEP_GRAPH, \
      (plan_syncs, graph_err)
  (recorded,) = records.values()
  kern = recorded[0]
  row = recorded_check("agent_swimmer_cost_sums", recorded, swim, card)
  entries.append(rollout_entry(
      "swimmer_cost_sums", row, "agent_swimmer",
      dict(agent_swimmer=stats["launches"]["rollout"]),
      layout=b1_layout(kern, row["K"])))

  # (c) iLQG on Swimmer under the Agent: B1 feedback, B2
  records.clear()
  with recording_rollouts(records):
    agent = Agent(swim, planner="iLQG")
  assert agent.planner.routes == dict(
      line_search="kernel", backward="kernel"), agent.planner.routes
  agent.plan_iteration()                  # loads the libraries
  torch.cuda.synchronize()
  zero_counts(counters)
  plan_ms, steps_ms, returns, feedback, per_plan = [], [], [], [], []
  for _ in range(AGENT_ILQG_PLANS):
    before = read_counts(counters)
    t0 = time.perf_counter()
    info = agent.plan_iteration()
    torch.cuda.synchronize()
    plan_ms.append((time.perf_counter() - t0) * 1e3)
    after = read_counts(counters)
    per_plan.append({k: after[k] - before[k] for k in after})
    returns.append(float(info["best_return"]))
    for _ in range(AGENT_STEPS_PER_PLAN):
      nominal = agent.planner.action(agent.data.time)
      feedback.append(float((agent.action() - nominal).abs().max()))
      t0 = time.perf_counter()
      agent.step_env()
      torch.cuda.synchronize()
      steps_ms.append((time.perf_counter() - t0) * 1e3)
  launches = read_counts(counters)
  path_launches["agent_swimmer_ilqg"] = launches
  emit("agent_swimmer_ilqg", H=agent.planner.config.horizon,
       plans=AGENT_ILQG_PLANS, plan_ms=plan_ms,
       plan_ms_p50=float(np.median(plan_ms)), step_ms=steps_ms,
       launches=launches, launches_per_plan=per_plan, best_return=returns,
       feedback_term_max=feedback, routes=agent.routes, card=card)
  assert all(p["rollout"] == 2 and p["riccati"] >= 1 for p in per_plan), \
      per_plan
  assert sum(p["riccati"] for p in per_plan) == launches["riccati"], \
      per_plan
  assert launches["rollout"] == 2 * AGENT_ILQG_PLANS, launches
  assert launches["scoring"] == 0 and launches["cholesky"] == 0, launches
  assert max(feedback) > 0.0, feedback
  assert all(np.isfinite(r) and r < 1e6 for r in returns), returns
  (recorded,) = records.values()
  kern = recorded[0]
  row = recorded_check("agent_swimmer_feedback", recorded, swim, card)
  entries.append(rollout_entry(
      "swimmer_feedback_h201", row, "agent_swimmer_ilqg",
      dict(agent_swimmer_ilqg=launches["rollout"]),
      layout=b1_layout(kern, row["K"])))

  # (d) the flagship under AgentRunner: the control thread sets the state
  # and reads actions at ~1 kHz while the plan thread plans
  quad = registry.get_task("Quadruped Flat", device=device)
  config = sampling.SamplingConfig(
      num_trajectory=K_MAIN, num_spline_points=SPLINE_POINTS,
      interp=Interpolation.ZERO, exploration=(EXPLORATION, 0.0),
      horizon=HORIZON)
  planner = sampling_lane.LaneSamplingPlanner(
      quad, config, device=device, contact_types=(GEOM_SPHERE,))
  runner = AgentRunner(quad, planner=planner, seed=SEED)
  home = quad.make_data().qpos.cpu().numpy()
  zero_qvel = np.zeros(quad.model.nv)
  lo, hi = quad.plan_model.actuator_ctrlrange.cpu().numpy().T
  zero_counts(counters)
  v0 = runner.policy_version

  def control_loop(seconds):
    """The control thread: state in, action out, every RUNNER_PERIOD_S;
    returns the action() latencies (µs) and the bad actions."""
    latency_us, bad = [], 0
    t_start = time.perf_counter()
    tick = t_start
    while (now := time.perf_counter()) - t_start < seconds:
      t_sim = now - t_start
      runner.set_state(qpos=home, qvel=zero_qvel, time=t_sim)
      t0 = time.perf_counter_ns()
      u = runner.action(t_sim)
      latency_us.append((time.perf_counter_ns() - t0) * 1e-3)
      bad += int(not (np.all(np.isfinite(u)) and np.all(u >= lo - 1e-6)
                      and np.all(u <= hi + 1e-6)))
      tick += RUNNER_PERIOD_S
      time.sleep(max(0.0, tick - time.perf_counter()))
    return latency_us, bad, time.perf_counter() - t_start

  runner.start()
  latency_us, bad, wall = control_loop(RUNNER_SECONDS)
  runner.stop()
  # the same loop with the plan thread stopped: what the contention costs
  idle_us, _, _ = control_loop(0.3)
  launches = read_counts(counters)
  path_launches["agent_runner_flagship"] = launches
  iterations = runner.iterations
  advance = runner.policy_version - v0
  # the same planner from the runner's last state on this thread alone,
  # each iteration synchronised and its policy read back as the plan thread
  # does (not counted)
  d0 = runner._snapshot()
  alone_ms = []
  for _ in range(5):
    t0 = time.perf_counter()
    planner.optimize(runner._gen, d0)
    runner._publish(planner.policy)
    alone_ms.append((time.perf_counter() - t0) * 1e3)
  emit("agent_runner_flagship", task="Quadruped Flat", K=K_MAIN, H=HORIZON,
       P=SPLINE_POINTS, seconds=wall, iterations=iterations,
       iterations_per_s=iterations / wall,
       plan_thread_ms_per_iteration=wall * 1e3 / max(iterations, 1),
       main_path_ms_per_iteration=main_ms,
       ms_per_iteration_alone_synchronised=alone_ms,
       policy_version_advance=advance,
       actions=len(latency_us), actions_bad=bad,
       action_us_p50=float(np.percentile(latency_us, 50)),
       action_us_p99=float(np.percentile(latency_us, 99)),
       action_us_max=float(np.max(latency_us)),
       action_us_p50_plan_thread_stopped=float(np.percentile(idle_us, 50)),
       action_us_p99_plan_thread_stopped=float(np.percentile(idle_us, 99)),
       launches=launches, card=card)
  assert iterations >= RUNNER_MIN_ITERATIONS, iterations
  assert advance == iterations and launches["rollout"] == iterations, \
      (advance, iterations, launches)
  assert bad == 0, bad
  emit("agent_paths", seconds=time.perf_counter() - t_phase, card=card)
  return entries


def nudged_plain(twin, args, kwargs, gen):
  """The plain version of `twin` on WITNESS_NUDGES copies of a launch's K
  lanes side by side (CPU tensors), each copy from qpos0 and qvel0 nudged
  by CONTROL_PERTURBATION (relative): one call over WITNESS_NUDGES x K
  lanes (a 1-D argument, the feedback mode's table, is shared). Returns its
  outputs (each with the lanes last) split back into WITNESS_NUDGES tuples
  of K lanes."""
  k = args[0].shape[1]
  lanes = []
  for i, a in enumerate(args):
    if a.dim() != 2:              # the feedback mode's per-step table
      lanes.append(a)
      continue
    wide = a.repeat(1, WITNESS_NUDGES)
    if i < 2:
      wide = wide * (1.0 + CONTROL_PERTURBATION * torch.randn(
          wide.shape, generator=gen))
    lanes.append(wide)
  out = twin.plain(*lanes, **kwargs)
  outs = out if isinstance(out, tuple) else (out,)
  return [tuple(o[..., j * k:(j + 1) * k] for o in outs)
          for j in range(WITNESS_NUDGES)]


def witness_check(err_k, err_w, tol):
  """Per candidate: the kernel's error from the plain version `err_k` (K,)
  within `tol`, or explained by the nudged plain version's own spread
  `err_w` (K,): err_w >= TOL_WITNESS_RATIO err_k. A candidate with a
  non-finite error is unexplained. Returns (fields to print, passes)."""
  over = ~(err_k <= tol)
  explained = err_w >= TOL_WITNESS_RATIO * err_k
  bad = over & ~explained
  return dict(candidates_over_tol=over.nonzero().flatten().tolist(),
              err_over_tol=err_k[over].tolist(),
              witness_err_over_tol=err_w[over].tolist(),
              witness_share_over_tol=float((err_w > tol).float().mean()),
              witness_max_err=float(err_w.max()),
              unexplained=int(bad.sum()), witness_nudges=WITNESS_NUDGES,
              tol_witness_ratio=TOL_WITNESS_RATIO), not bool(bad.any())


def walker_cost_sums_check(name, recorded, task, card):
  """A contact-rich cost-sum launch of a path (Walker standing under the
  agent: 81 steps with the feet on the floor) held against the plain
  version on the same inputs: its returns per candidate within
  TOL_RETURN_REL, or the gap explained by the nudged plain witness
  (`witness_check`). A states build of the same specialisation (the same
  inputs, every state recorded) is held step by step over the whole
  horizon against the plain version beside the nudged control, with the
  plain version's residual rows at the kernel's states to TOL_ROWS, and
  the cost-sum launch's returns to the returns of the states build's own
  rows (the reduction, TOL_RETURN_REL). The plain version runs on the
  host's CPU, from a twin of the build. Returns the row of the build's
  summary entry."""
  from mujoco_mpc_tpu_torch.ops import step_lane
  from mujoco_mpc_tpu_torch.tasks import registry

  kern, (build_a, build_kw), args, _ = recorded
  defs = kern.build_defines()
  horizon, p = defs["LR_H"], build_a[2]
  naux = task.lane_residual_spec()["naux"]
  m = task.plan_model
  nq, nv = m.nq, m.nv
  kw = {k: v for k, v in build_kw.items() if k != "cost_terms"}
  kw["record_states"] = True
  states = step_lane.build_rollout_kernel(*build_a, **kw)
  twin_task = registry.get_task(task.name, device="cpu")
  twin = step_lane.build_rollout_kernel(
      twin_task.plan_model, *build_a[1:],
      **dict(kw, residual=twin_task.lane_residual_spec()))
  assert twin.build_defines() == states.build_defines()
  qpos0, qvel0, values, aux = args
  aux_s = aux[:naux].contiguous()
  rec = states(qpos0, qvel0, values, aux_s)         # (H, nq + nv + nr, K)
  sums, _ = kern(*args)
  torch.cuda.synchronize()
  w = task.cost_spec.weights[:, None]
  ret = (w * sums).sum(dim=0) / horizon
  rows = rec[:, nq + nv:].permute(2, 0, 1)          # (K, H, nr)
  ret_rows = task.cost_spec.cost(rows).sum(dim=1) / horizon
  rel = (ret - ret_rows).abs() / torch.clamp(ret_rows.abs(), min=1.0)
  rec_c, values_c, aux_c = rec.cpu(), values.cpu(), aux_s.cpu()
  gen_c = torch.Generator().manual_seed(SEED)
  steps = step_by_step(twin, rec_c, values_c, aux_c, p, nq, nv, gen_c,
                       steps_as_lanes=True)
  plain_args = (qpos0.cpu(), qvel0.cpu(), values_c, aux_c)

  def plain_returns(rec_p):
    return task.cost_spec.cost(rec_p[:, nq + nv:].permute(2, 0, 1).to(
        ret.device)).sum(dim=1) / horizon

  # the plain version's whole rollout of the same inputs, timed, and the
  # witness: its rollouts from the nudged start
  t0 = time.perf_counter()
  ret_plain = plain_returns(twin.plain(*plain_args))
  plain_ms = (time.perf_counter() - t0) * 1e3

  def rel_to_plain(r):
    return (r - ret_plain).abs() / torch.clamp(ret_plain.abs(), min=1.0)

  nudged = nudged_plain(twin, plain_args, {},
                        torch.Generator().manual_seed(SEED + 1))
  rel_w = torch.stack([rel_to_plain(plain_returns(o[0]))
                       for o in nudged]).amax(dim=0)
  rel_k = rel_to_plain(ret)
  finite = torch.isfinite(ret) & torch.isfinite(ret_plain)
  witness, whole_ok = witness_check(rel_k[finite], rel_w[finite],
                                    TOL_RETURN_REL)
  nb, nf, bytes_ms, ops_ms = kernel_bound(kern, args, (sums,), horizon,
                                          qpos0.shape[1])
  row = dict(K=qpos0.shape[1], H=horizon, mode=kern.mode,
             kernel_ms=time_cuda(lambda: kern(*args), 10),
             plain_ms=plain_ms, plain_on="cpu", steps=steps,
             whole_rollout_vs_plain=dict(
                 median_rel=float(rel_k.median()), max_rel=float(rel_k.max()),
                 share_over_tol_return_rel=float(
                     (rel_k > TOL_RETURN_REL).float().mean()),
                 nonfinite=int((~finite).sum()), **witness),
             tol_rows=TOL_ROWS,
             max_abs_err_return=float((ret - ret_plain).abs().max()),
             max_abs_err_return_vs_rows=float((ret - ret_rows).abs().max()),
             max_rel_return_vs_rows=float(rel.max()),
             tol_return_rel=TOL_RETURN_REL,
             active_contact_points_t0=int((torch.stack([
                 g for _, _, g in step_lane.contact_gaps(m, rec[0, :nq])])
                 < 0).sum()),
             bytes=nb, flops=nf, bytes_ms=bytes_ms, ops_ms=ops_ms)
  emit("kernels", case=name, card=card, **row)
  assert steps["passes"] and steps["median_err_qpos"] <= TOL_STEP_MEDIAN, \
      row
  assert steps["max_err_rows_rel"] <= TOL_ROWS, row
  assert float(rel.max()) <= TOL_RETURN_REL, row
  assert int((~finite).sum()) <= TOL_NONFINITE_SHARE * row["K"], row
  assert whole_ok, row
  return row


def walker_builds(device):
  """Phase 11's task and rollout-kernel builds: Walker in feedback mode at
  BASELINE config 2b's horizon (the iLQG line searches) and in cost-sum
  mode at its own sampling configuration (the agent's lane planner), and
  the Riccati kernel at Walker's size. The planners find them built."""
  from mujoco_mpc_tpu_torch.ops import riccati_lane, step_lane
  from mujoco_mpc_tpu_torch.planners import ilqg, sampling
  from mujoco_mpc_tpu_torch.tasks import registry

  walker = registry.get_task("Walker", device=device)
  spec = walker.lane_residual_spec()
  m = walker.plan_model
  cfg = sampling.make_config(walker)
  assert (cfg.num_trajectory, cfg.horizon, cfg.num_spline_points) == (
      K_WALKER_AGENT, HORIZON_WALKER_AGENT, 3), cfg
  kernels = {
      "walker_feedback": step_lane.build_rollout_kernel(
          m, HORIZON_WALKER_ILQG, 1, residual=spec, naux=spec["naux"],
          record_states=True, feedback=True),
      "walker_cost_sums": step_lane.build_rollout_kernel(
          m, cfg.horizon, cfg.num_spline_points, residual=spec,
          naux=spec["naux"], record_states=False, cost_terms=tuple(zip(
              walker.cost_spec.norm_types, walker.cost_spec.dims))),
      # the states build the cost-sums launch is checked through
      "walker_states": step_lane.build_rollout_kernel(
          m, cfg.horizon, cfg.num_spline_points, residual=spec,
          naux=spec["naux"], record_states=True)}
  qp_iters = ilqg.make_config(walker).boxqp_iters
  riccati = riccati_lane.build_backward_kernel(2 * m.nv, m.nu,
                                               HORIZON_WALKER_ILQG, qp_iters,
                                               0)
  return walker, kernels, riccati


def gradient_kernel_inputs():
  """While active, every batched Cholesky launch recorded into a CUDA graph
  keeps a reference to its inputs (the graph's own buffers, which each
  replay overwrites with that launch's inputs), and every fused scoring
  launch a copy of its inputs."""
  from mujoco_mpc_tpu_torch.ops import cholesky, scoring

  seen = dict(chol=[], score=[])
  launch_chol, launch_score = cholesky._launch, scoring._launch

  def chol(a, b):
    if torch.cuda.is_current_stream_capturing():
      seen["chol"].append((a, b))
    return launch_chol(a, b)

  def score(res, cs):
    seen["score"].append((res.clone(), cs))
    return launch_score(res, cs)

  @contextlib.contextmanager
  def active():
    cholesky._launch, scoring._launch = chol, score
    try:
      yield seen
    finally:
      cholesky._launch, scoring._launch = launch_chol, launch_score

  return active


@contextlib.contextmanager
def eager_bodies():
  """Inside the block every rollout.GraphedBody made runs its function
  eagerly at each call, uncaptured: the route the CUDA graphs replace."""
  from mujoco_mpc_tpu_torch import rollout

  class Eager:
    def __init__(self, body, device):
      self.body = body

    def __call__(self):
      self.body()

  graphed = rollout.GraphedBody
  rollout.GraphedBody = Eager
  try:
    yield
  finally:
    rollout.GraphedBody = graphed


def device_total_ms(fn):
  """Device milliseconds of one call of fn(): the summed durations of the
  device kernels and copies it runs, from torch.profiler (the card's own
  time, without the host's); None where the profiler shows no device
  work. The profiler's raw records are read (a graph replay makes tens of
  thousands, which its Python event tree takes seconds to build)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  ns = [ev.duration_ns() for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == cuda]
  return sum(ns) / 1e6 if ns else None


def event_ms(fn):
  """Milliseconds between CUDA events recorded before and after one call
  of fn() whose device work is one CUDA graph replay and a few copies (its
  host enqueue is far shorter than the graph): the device's elapsed time,
  gaps between the graph's nodes included."""
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end)


def percentiles(xs):
  xs = [x for x in xs if x is not None]
  if not xs:
    return dict(p50=None, p90=None)
  return dict(p50=float(np.percentile(xs, 50)),
              p90=float(np.percentile(xs, 90)))


def timed_updates(update, n, n_device=None):
  """Wall milliseconds of n calls of update() (each up to a synchronise),
  then the device milliseconds of n_device (default n) more (profiler, and
  CUDA events around each), and the synchronising calls of one more."""
  n_device = n if n_device is None else n_device
  wall = []
  for _ in range(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    update()
    torch.cuda.synchronize()
    wall.append((time.perf_counter() - t0) * 1e3)
  dev = [device_total_ms(update) for _ in range(n_device)]
  ev = [event_ms(update) for _ in range(n_device)]
  _, syncs = count_syncs(update)
  return dict(wall_ms=percentiles(wall), device_ms=percentiles(dev),
              device_ms_events=percentiles(ev), host_syncs_per_update=syncs,
              device_ms_from="profiler" if dev[0] is not None
              else "not measured by the profiler")


def cartpole_truth(task, n, seed, step):
  """(states (n, 4), noisy sensors (n, 5), ctrls (n, 1), actuator forces
  (n, 2)) of Cartpole from a swinging start under a smooth control: each
  reading on a full forward pass (one CUDA graph) plus 0.01 N(0, 1), then
  the step (`step`, the agent's step graph)."""
  from mujoco_mpc_tpu_torch import rollout
  from mujoco_mpc_tpu_torch.physics import forward as F
  from mujoco_mpc_tpu_torch.physics import sensors

  m = task.model
  fn = sensors.make_sensor_fn(m)
  rng = np.random.default_rng(seed)
  d = d0 = task.make_data().replace(
      qpos=torch.tensor([0.0, 2.0], device=m.qpos0.device))

  def read(qpos, qvel, u):
    df = F.forward(m, d0.replace(qpos=qpos, qvel=qvel, ctrl=u))
    return torch.cat([qpos, qvel, fn(m, df), u, df.qfrc_actuator]),

  reading = rollout.GraphedFn(read, m.qpos0.device)
  ctrls = torch.tensor(0.3 * np.sin(0.2 * np.arange(n)), dtype=torch.float32,
                       device=m.qpos0.device)[:, None]
  rows = []
  for t in range(n):
    u = ctrls[t]
    rows.append(reading(d.qpos, d.qvel, u)[0])
    d = step(d.replace(ctrl=u))
  rows = torch.stack(rows).cpu().numpy().astype(np.float64)
  states, ys = rows[:, :4], rows[:, 4:9]
  ys = ys + 0.01 * rng.standard_normal(ys.shape)
  return states, ys, rows[:, 9:10], rows[:, 10:12]


def chol_entry_row(pairs):
  """B4 held to its plain version on every captured (a, b), and timed on
  the first: the device time of a launch in a graph, the profiler's, the
  plain version's and `torch.linalg.solve`'s, the bound."""
  from mujoco_mpc_tpu_torch.ops import cholesky
  errs = []
  for a, b in pairs:
    x = cholesky._launch(a, b)
    xp = cholesky.chol_solve_lanes_plain(a, b)
    torch.cuda.synchronize()
    errs.append((float((x - xp).abs().max()), bool(
        ((x - xp).abs() <= TOL_CHOL + TOL_CHOL * xp.abs()).all())))
  a, b = (x.contiguous() for x in pairs[0])
  n, k = b.shape
  cb, co = chol_work(n, k)
  am, bm = a.permute(2, 0, 1).contiguous(), b.T.contiguous()[..., None]
  return dict(
      n=n, K=k, systems_checked=len(pairs),
      max_abs_err=max(e for e, _ in errs), within_tol=all(ok for _, ok in errs),
      graph_ms=graph_launch_ms(lambda: cholesky._launch(a, b)),
      device_ms=device_ms(lambda: cholesky._launch(a, b), 50,
                          "chol_solve_lanes"),
      plain_ms=host_ms(lambda: cholesky.chol_solve_lanes_plain(a, b)),
      library_ms=time_cuda(lambda: torch.linalg.solve(am, bm), 20),
      layout=cholesky.layout(n), bytes=cb, flops=co,
      bytes_ms=cb / H100_BYTES_PER_S * 1e3, ops_ms=co / H100_F32_FLOPS * 1e3)


def score_entry_row(res, cs):
  """B3 held to its plain version on a path's own captured (T, nr, K)
  residuals, and timed there (as phase 11's line-search check)."""
  from mujoco_mpc_tpu_torch.ops import scoring
  got = scoring._launch(res, cs)
  want = scoring.score_reference(res.permute(2, 0, 1), cs)
  err = float((got - want).abs().max())
  ok = bool(((got - want).abs() <= TOL_SCORE + TOL_SCORE *
             want.abs()).all())
  sb, so = score_work(cs, res.shape[0], res.shape[2])
  return dict(
      T=res.shape[0], nr=res.shape[1], K=res.shape[2], max_abs_err=err,
      within_tol=ok, graph_ms=graph_launch_ms(lambda: scoring._launch(res,
                                                                      cs)),
      device_ms=device_ms(lambda: scoring._launch(res, cs), 50,
                          "score_fused"),
      plain_ms=host_ms(lambda: scoring.score_reference(
          res.permute(2, 0, 1), cs)),
      bytes=sb, flops=so, bytes_ms=sb / H100_BYTES_PER_S * 1e3,
      ops_ms=so / H100_F32_FLOPS * 1e3)


def kernel_entry(name, source, replaces, launches_by_path, row, shape):
  return dict(
      name=name, route="cuda", source="mujoco_mpc_tpu_torch/ops/csrc/" +
      source, replaces=replaces,
      launches=sum(launches_by_path.values()),
      launches_by_path=launches_by_path, max_abs_err=row["max_abs_err"],
      ms=row["graph_ms"], device_ms=row["device_ms"],
      plain_ms=row["plain_ms"],
      bound_ms=max(row["bytes_ms"], row["ops_ms"]),
      bound_by="bytes" if row["bytes_ms"] >= row["ops_ms"]
      else "operations", library_ms=row.get("library_ms"), shape=shape)


def estimator_paths(counters, path_launches, card, device):
  """Phase 12: the estimators and the Direct optimizer on Cartpole. The
  EKF and the UKF in the agent loop (the lane planner planning from the
  filter's state; each filter update one CUDA graph, the UKF's sigma
  points stepped on B4), Batch at its default window and at 32, Direct at
  T=32 (banded). Adds each path's launches to `path_launches` and returns
  the summary entries of B1, B3 and B4 held to their plain versions at the
  phase's own shapes."""
  from mujoco_mpc_tpu_torch.agent.agent import Agent
  from mujoco_mpc_tpu_torch.rollout import StepGraph
  from mujoco_mpc_tpu_torch.direct.optimizer import Direct
  from mujoco_mpc_tpu_torch.estimators.batch import Batch
  from mujoco_mpc_tpu_torch.tasks import registry

  t_phase = time.perf_counter()
  entries, captured_score, captured_chol = [], None, []
  seconds = {}
  inputs = gradient_kernel_inputs()
  records = {}
  for case, est_name in (("agent_cartpole_ekf", "Kalman"),
                         ("agent_cartpole_ukf", "Unscented")):
    records.clear()
    with recording_rollouts(records), inputs() as seen:
      seen["chol"].clear()
      seen["score"].clear()
      cart = registry.get_task("Cartpole", device=device)
      agent = Agent(cart, planner="Sampling", seed=1, estimator=est_name,
                    sensor_noise=0.01)
      assert agent.routes["planner"] == "LaneSamplingPlanner", agent.routes
      zero_counts(counters)
      errs = []
      t0 = time.perf_counter()
      for t in range(FILTER_STEPS):
        if t % AGENT_STEPS_PER_PLAN == 0:
          for _ in range(FILTER_PLANS):
            agent.plan_iteration()
        agent.step_env()
        true_x = torch.cat([agent.data.qpos, agent.data.qvel])
        errs.append(torch.linalg.vector_norm(
            agent.estimator.state_tensor[:4] - true_x))
      errs = torch.stack(errs).cpu().numpy()
      loop_s = time.perf_counter() - t0
      launches = read_counts(counters)
      vertical = float(cart.residual(cart.model, agent.data,
                                     cart.residual_params)[0])
      path_launches[case] = launches
      if est_name == "Unscented":
        captured_chol = [(a, b) for a, b in seen["chol"]]
      captured_score = seen["score"][-1]
    u = agent.data.ctrl
    timing = timed_updates(lambda: agent._feed_estimator(u), TIMED_UPDATES)
    tail = float(np.mean(errs[-FILTER_TAIL:]))
    plans = FILTER_STEPS // AGENT_STEPS_PER_PLAN * FILTER_PLANS
    seconds[case] = time.perf_counter() - t0
    emit(case, task="Cartpole", estimator=est_name, K=10, H=101,
         steps=FILTER_STEPS, plans=plans, sensor_noise=0.01,
         estimation_error_tail_mean=tail, bar=FILTER_ERR_BAR,
         estimation_error_max=float(errs.max()), vertical=vertical,
         vertical_bar=VERTICAL_BAR, loop_s=loop_s,
         realtime_factor=FILTER_STEPS * agent.timestep / loop_s,
         filter_update=timing, launches=launches, routes=agent.routes,
         card=card)
    assert np.isfinite(errs).all() and tail < FILTER_ERR_BAR, tail
    assert abs(vertical) < VERTICAL_BAR, vertical
    assert launches["rollout"] == plans and launches["scoring"] == plans, \
        launches
    assert launches["riccati"] == 0, launches
    if est_name == "Kalman":
      assert launches["cholesky"] == 0, launches
      (recorded,) = records.values()
      row = recorded_check("agent_cartpole_ekf_states", recorded, cart, card)
    else:
      # the sigma points' SPD solves: B4 at (nv, 2 ndx + 1), every update
      assert launches["cholesky"] >= FILTER_STEPS, launches
      assert captured_chol and all(
          tuple(b.shape) == (2, 9) for _, b in captured_chol), \
          [tuple(b.shape) for _, b in captured_chol]
  filter_paths = ("agent_cartpole_ekf", "agent_cartpole_ukf")
  entries.append(dict(
      rollout_entry("cartpole_states[estimator_paths]", row,
                    "agent_cartpole_ekf", path_launches,
                    shape=dict(K=10, H=101)),
      launches=sum(path_launches[k]["rollout"] for k in filter_paths),
      launches_by_path={k: path_launches[k]["rollout"]
                        for k in filter_paths}))
  score_row = score_entry_row(*captured_score)
  chol_row = chol_entry_row(captured_chol)
  emit("estimator_paths", case="kernels_on_the_paths_inputs",
       score_fused=score_row, chol_solve_lanes=chol_row,
       tol_score=TOL_SCORE, tol_chol=TOL_CHOL, card=card)
  assert score_row["within_tol"] and chol_row["within_tol"], (score_row,
                                                             chol_row)
  assert (score_row["K"], score_row["T"]) == (10, 101), score_row
  entries.append(kernel_entry(
      "scoring.score_fused[estimator_paths]", "score_fused.cu",
      "mujoco_mpc_tpu/ops/scoring.py:47",
      {k: path_launches[k]["scoring"] for k in filter_paths}, score_row, dict(K=10, T=101)))
  entries.append(kernel_entry(
      "cholesky.chol_solve_lanes[estimator_paths]", "chol_solve_lanes.cu",
      "mujoco_mpc_tpu/ops/cholesky.py:66",
      dict(agent_cartpole_ukf=path_launches["agent_cartpole_ukf"][
          "cholesky"]), chol_row, dict(n=2, K=9)))

  # Batch: a recorded noisy Cartpole run, the filter started off the truth
  cart = registry.get_task("Cartpole", device=device)
  step = StepGraph(cart.model)
  for length in BATCH_LENGTHS:
    t0 = time.perf_counter()
    zero_counts(counters)
    est = Batch(cart, configuration_length=length)
    # the window, then timed_updates' n + 2 n_device + 1
    n = est.cfg_len + TIMED_UPDATES + 2 * DEVICE_UPDATES + 1
    states, ys, ctrls, _ = cartpole_truth(cart, n + 1, SEED + length
                                          if length else SEED, step)
    x0 = states[0].copy()
    x0[:2] += 0.2 * np.random.default_rng(SEED).standard_normal(2)
    est.set_state(x0)
    t = 1
    for _ in range(est.cfg_len):
      est.update(ctrls[t], ys[t])
      t += 1

    def update():
      nonlocal t
      est.update(ctrls[t], ys[t])
      t += 1

    timing = timed_updates(update, TIMED_UPDATES, DEVICE_UPDATES)
    err = float(np.linalg.norm(est.state[:2] - states[t - 1][:2]))
    launches = read_counts(counters)
    name = f"batch_cartpole_{est.cfg_len}"
    path_launches[name] = launches
    seconds[name] = time.perf_counter() - t0
    emit("batch_cartpole", window=est.cfg_len, banded=est.direct.banded,
         updates=t - 1, update=timing, iterations=est.direct.iterations,
         cost_history=est.direct.cost_history,
         status=int(est.direct.status), cost=est.direct.cost,
         qpos_error_final=err, bar=BATCH_ERR_BAR, launches=launches,
         seconds=seconds[name], card=card)
    assert np.isfinite(est.state).all() and err < BATCH_ERR_BAR, err
    assert all(v == 0 for v in launches.values()), launches

  # Direct at T=32 on a noisy recorded window
  t0 = time.perf_counter()
  zero_counts(counters)
  states, ys, ctrls, forces = cartpole_truth(cart, DIRECT_HORIZON, SEED,
                                             step)
  qs = states[:, :2]
  noisy = qs + DIRECT_NOISE * np.random.default_rng(SEED).standard_normal(
      qs.shape)
  direct = Direct(cart, DIRECT_HORIZON)
  assert direct.banded
  for k in range(DIRECT_HORIZON):
    direct.set_data(k, qpos=noisy[k], sensor=ys[k], force=forces[k])
  direct.set_weights(sensor=1e4, force=1.0)
  direct.optimize()                       # captured here, then replayed
  seconds["direct_capture"] = time.perf_counter() - t0
  timing = timed_updates(direct.optimize, DIRECT_REPS, DEVICE_UPDATES)
  q_err = float(np.linalg.norm(direct.qpos_optimized - qs))
  q_err0 = float(np.linalg.norm(noisy - qs))
  launches = read_counts(counters)
  path_launches["direct_cartpole"] = launches
  seconds["direct_cartpole"] = time.perf_counter() - t0
  emit("direct_cartpole", T=DIRECT_HORIZON, banded=True, optimize=timing,
       iterations=direct.iterations, cost_history=direct.cost_history,
       status=int(direct.status),
       status_name=direct.status.name, cost_initial=direct.cost_initial,
       cost=direct.cost, qpos_error=q_err, qpos_error_initial=q_err0,
       launches=launches, card=card)
  assert direct.cost < direct.cost_initial, (direct.cost,
                                             direct.cost_initial)
  assert len(direct.cost_history) == direct.iterations + 1, \
      direct.cost_history
  assert q_err < 0.5 * q_err0, (q_err, q_err0)
  emit("estimator_paths", seconds=time.perf_counter() - t_phase,
       seconds_by_case=seconds, card=card)
  return entries


def contact_gradient_paths(counters, path_launches, card, device,
                           built=None):
  """Phase 11: the Gradient planner on Swimmer (graph-replayed forward and
  reverse passes, the line search's batched rollouts on B4 and B3), iLQG on
  Walker at BASELINE config 2b (derivatives through the contact rows, B1
  feedback with capsule ground contacts, B2 at Walker's size) and Walker
  under the agent (the lane sampler; step_env a CUDA graph of the contact
  pipeline step). Adds each path's launches to `path_launches` and returns
  the summary entries of the builds and sizes the phase brings."""
  from mujoco_mpc_tpu_torch import testspeed
  from mujoco_mpc_tpu_torch.agent.agent import Agent
  from mujoco_mpc_tpu_torch.ops import (cholesky, riccati_lane, scoring,
                                        step_lane)
  from mujoco_mpc_tpu_torch.planners import base as planner_base
  from mujoco_mpc_tpu_torch.planners import gradient, ilqg
  from mujoco_mpc_tpu_torch.tasks import registry

  t_phase = time.perf_counter()
  walker, _, riccati = built or walker_builds(device)
  entries = []

  def stage_ms(events, names):
    return {n: float(np.mean([e[p].elapsed_time(e[n]) for e in events]))
            for p, n in zip(names, names[1:])}

  # (a) Gradient on Swimmer at its own configuration (H=201)
  swim = registry.get_task("Swimmer", device=device)
  inputs = gradient_kernel_inputs()
  with inputs() as seen:
    planner = planner_base.make_planner(swim, "Gradient", device)
    assert isinstance(planner, gradient.GradientPlanner)
    assert planner.routes == dict(
        value_and_grad="vjp_graphs", line_search="pipeline_graph",
        spd_solve="kernel", scoring="kernel"), planner.routes
    cfg = planner.config
    assert (cfg.horizon, cfg.num_spline_points, cfg.num_steps) == (201, 10,
                                                                    8), cfg
    d0 = swim.make_data()
    warmup = {"start": time.perf_counter()}

    def host_mark(stage):
      torch.cuda.synchronize()
      warmup[stage] = time.perf_counter()

    # warm-up: each step graph is run once and captured
    planner.optimize(None, d0, mark=host_mark)
    warmup_s = {n: warmup[n] - warmup[p] for p, n in zip(
        ("start", "forward", "reverse"),
        ("forward", "reverse", "line_search"))}
  captured_chol = list(seen["chol"])
  zero_counts(counters)
  events, infos = [], []

  def mark(stage):
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    events[-1][stage] = event

  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(GRADIENT_ITERATIONS):
    events.append({})
    infos.append(planner.optimize(None, d0, mark=mark))
  end.record()
  torch.cuda.synchronize()
  launches = read_counts(counters)
  path_launches["gradient_path"] = launches
  grad_ms = start.elapsed_time(end) / GRADIENT_ITERATIONS
  seen["score"].clear()
  with inputs():
    _, syncs = count_syncs(lambda: planner.optimize(None, d0))
    torch.cuda.synchronize()
  stages = stage_ms(events, ("start", "forward", "reverse", "line_search"))
  nominal = [float(i["nominal_return"]) for i in infos]
  best = [float(i["best_return"]) for i in infos]
  gnorm = [float(i["grad_norm"]) for i in infos]
  emit("gradient_path", task="Swimmer", H=cfg.horizon,
       P=cfg.num_spline_points, line_search_candidates=cfg.num_steps,
       iterations=GRADIENT_ITERATIONS, ms_per_iteration=grad_ms,
       stage_ms=stages, glue_ms=grad_ms - sum(stages.values()),
       warmup_s=warmup_s, host_syncs_per_iteration=syncs, launches=launches,
       cholesky_launches_per_iteration=launches["cholesky"] /
       GRADIENT_ITERATIONS,
       nominal_return=nominal, best_return=best, grad_norm=gnorm,
       step=[float(i["step"]) for i in infos],
       improved=[bool(i["improved"]) for i in infos], routes=planner.routes,
       card=card)
  assert launches["scoring"] == GRADIENT_ITERATIONS, launches
  assert launches["cholesky"] > 0 and launches["cholesky"] % \
      GRADIENT_ITERATIONS == 0, launches
  assert launches["rollout"] == 0 and launches["riccati"] == 0, launches
  for i in range(GRADIENT_ITERATIONS):
    assert np.isfinite(nominal[i]) and np.isfinite(best[i]), (nominal, best)
    assert best[i] <= nominal[i] and nominal[i] < 1e6, (i, best, nominal)
    assert np.isfinite(gnorm[i]) and gnorm[i] > 1e-9, gnorm
  assert syncs == 0, syncs

  # B3 and B4 on the line search's own inputs: the scorer's residuals of
  # the last iteration, and the Cholesky systems of the line search's last
  # replayed step (the graph's own input buffers)
  (res, cs), = seen["score"]
  got = scoring._launch(res, cs)
  want = scoring.score_reference(res.permute(2, 0, 1), cs)
  torch.cuda.synchronize()
  err_score = float((got - want).abs().max())
  score_ok = bool(((got - want).abs() <= TOL_SCORE +
                   TOL_SCORE * want.abs()).all())
  sb, so = score_work(cs, res.shape[0], res.shape[2])
  score_row = dict(
      T=res.shape[0], nr=res.shape[1], K=res.shape[2],
      strides=list(res.stride()), max_abs_err=err_score, within_tol=score_ok,
      graph_ms=graph_launch_ms(lambda: scoring._launch(res, cs)),
      device_ms=device_ms(lambda: scoring._launch(res, cs), 50,
                          "score_fused"),
      call_ms=time_cuda(lambda: scoring._launch(res, cs), 50),
      plain_ms=host_ms(lambda: scoring.score_reference(
          res.permute(2, 0, 1), cs)),
      layout=scoring.layout(res.shape[2], res.shape[0],
                            scoring.sm_count(torch.cuda.current_device())),
      bytes=sb, flops=so, bytes_ms=sb / H100_BYTES_PER_S * 1e3,
      ops_ms=so / H100_F32_FLOPS * 1e3)
  line_chol = [(a, b) for a, b in captured_chol
               if a.shape[-1] == cfg.num_steps]
  assert line_chol, [tuple(a.shape) for a, _ in captured_chol]
  chol_errs = []
  for a, b in line_chol:
    x = cholesky._launch(a, b)
    xp = cholesky.chol_solve_lanes_plain(a, b)
    torch.cuda.synchronize()
    chol_errs.append((float((x - xp).abs().max()), bool(
        ((x - xp).abs() <= TOL_CHOL + TOL_CHOL * xp.abs()).all())))
  a, b = (x.contiguous() for x in line_chol[0])
  n, k = b.shape
  cb, co = chol_work(n, k)
  am, bm = a.permute(2, 0, 1).contiguous(), b.T.contiguous()[..., None]
  chol_row = dict(
      n=n, K=k, systems_checked=len(line_chol),
      max_abs_err=max(e for e, _ in chol_errs),
      within_tol=all(ok for _, ok in chol_errs),
      graph_ms=graph_launch_ms(lambda: cholesky._launch(a, b)),
      device_ms=device_ms(lambda: cholesky._launch(a, b), 50,
                          "chol_solve_lanes"),
      call_ms=time_cuda(lambda: cholesky._launch(a, b), 50),
      plain_ms=host_ms(lambda: cholesky.chol_solve_lanes_plain(a, b)),
      library_ms=time_cuda(lambda: torch.linalg.solve(am, bm), 20),
      layout=cholesky.layout(n), bytes=cb, flops=co,
      bytes_ms=cb / H100_BYTES_PER_S * 1e3, ops_ms=co / H100_F32_FLOPS * 1e3)
  emit("gradient_path", case="kernels_on_the_line_search_inputs",
       score_fused=score_row, chol_solve_lanes=chol_row, tol_score=TOL_SCORE,
       tol_chol=TOL_CHOL, card=card)
  assert score_ok and chol_row["within_tol"], (score_row, chol_row)

  # the graph route against the eager route at a short horizon, from the
  # same policy: value and gradient, and the line search's returns; the
  # eager route runs the same step functions uncaptured
  short = cfg.replace(horizon=GRADIENT_CHECK_HORIZON)
  outs = {}
  for g in (True, False):
    with contextlib.nullcontext() if g else eager_bodies():
      p = gradient.GradientPlanner(swim, short, device=device)
      p.policy = planner.policy
      t0 = time.perf_counter()
      info = p.optimize(None, d0)
      torch.cuda.synchronize()
    outs[g] = (info, time.perf_counter() - t0)
  (gi, g_s), (ei, e_s) = outs[True], outs[False]
  graph_err = dict(
      nominal_return=abs(float(gi["nominal_return"] - ei["nominal_return"])),
      grad_norm=abs(float(gi["grad_norm"] - ei["grad_norm"])),
      returns=float((gi["returns"] - ei["returns"]).abs().max()),
      candidates=float((gi["candidates"] - ei["candidates"]).abs().max()))
  emit("gradient_path", case="graphs_vs_eager", H=GRADIENT_CHECK_HORIZON,
       graph_s_first_call=g_s, eager_s=e_s, abs_err=graph_err,
       tol_rel=TOL_GRAPH_VS_EAGER, card=card)
  for key in ("nominal_return", "grad_norm"):
    assert graph_err[key] <= TOL_GRAPH_VS_EAGER * abs(float(ei[key])), \
        graph_err
  assert graph_err["returns"] <= TOL_GRAPH_VS_EAGER * float(
      ei["returns"].abs().max()), graph_err

  # (b) iLQG on Walker at BASELINE config 2b (H=32) from the task's start
  records = {}
  with recording_rollouts(records):
    wplanner = ilqg.ILQGPlanner(walker, ilqg.make_config(walker).replace(
        horizon=HORIZON_WALKER_ILQG), device=device)
  assert wplanner.routes == dict(line_search="kernel", backward="kernel"), \
      wplanner.routes
  wm = walker.plan_model
  wd0 = walker.make_data()
  wplanner.optimize(None, wd0)         # warm-up
  torch.cuda.synchronize()
  zero_counts(counters)
  events, winfos = [], []
  start.record()
  for _ in range(WALKER_ILQG_ITERATIONS):
    events.append({})
    winfos.append(wplanner.optimize(None, wd0, mark=mark))
  end.record()
  torch.cuda.synchronize()
  launches = read_counts(counters)
  path_launches["walker_ilqg_path"] = launches
  wms = start.elapsed_time(end) / WALKER_ILQG_ITERATIONS
  wstages = stage_ms(events, ("start", "nominal_line_search", "derivatives",
                              "backward", "action_line_search"))
  sweeps = [i["backward_sweeps"] for i in winfos]
  nominal = [float(i["nominal_return"]) for i in winfos]
  best = [float(i["best_return"]) for i in winfos]
  ncon_rows = 4 * wm.collision_pairs.ncon
  emit("walker_ilqg_path", task="Walker", config="2b", H=HORIZON_WALKER_ILQG,
       ndx=2 * wm.nv, nu=wm.nu, contact_rows=ncon_rows,
       iterations=WALKER_ILQG_ITERATIONS, ms_per_iteration=wms,
       stage_ms=wstages, glue_ms=wms - sum(wstages.values()),
       launches=launches, backward_sweeps_per_iteration=sweeps,
       nominal_return=nominal, best_return=best,
       reg=[float(i["reg"]) for i in winfos], card=card)
  assert launches["rollout"] == 2 * WALKER_ILQG_ITERATIONS, launches
  assert launches["riccati"] == sum(sweeps) >= WALKER_ILQG_ITERATIONS, \
      (launches, sweeps)
  assert launches["scoring"] == 0 and launches["cholesky"] == 0, launches
  for i in range(WALKER_ILQG_ITERATIONS):
    assert np.isfinite(best[i]) and best[i] <= nominal[i] < 1e6, \
        (i, best, nominal)
  # one more iteration, both kernels held against their plain versions on
  # the planner's own inputs: B2 on every sweep, B1 on its last launch
  build_backward = riccati_lane.build_backward_kernel
  riccati_checks = []

  def checked_backward(*a, **kw):
    kern = build_backward(*a, **kw)

    def backward(*args):
      riccati_checks.append(check_riccati_on_path(kern, args))
      return kern(*args)

    return backward

  riccati_lane.build_backward_kernel = checked_backward
  try:
    checked = ilqg.ILQGPlanner(walker, wplanner.config, device=device)
  finally:
    riccati_lane.build_backward_kernel = build_backward
  checked.policy = wplanner.policy
  checked.optimize(None, wd0)
  torch.cuda.synchronize()
  (recorded,) = records.values()
  row = recorded_check("walker_feedback_on_path", recorded, walker, card)
  emit("walker_ilqg_path", case="riccati_on_the_planners_inputs",
       riccati=riccati_checks, card=card)
  assert riccati_checks and all(r["passes"] for r in riccati_checks), \
      riccati_checks
  # config 2b starts airborne, so the path's own feedback launches see no
  # ground row: a new planner's first iteration from a pressed state (the
  # lowest foot 2 mm into the floor: a walker started on the floor), its
  # last feedback launch held to the plain version, the whole-rollout
  # gaps explained by the nudged witness
  pressed_q = wd0.qpos.clone()
  pressed_q[1] -= step_lane.contact_clearance(wm, pressed_q) + 0.002
  records.clear()
  with recording_rollouts(records):
    pressed_planner = ilqg.ILQGPlanner(walker, wplanner.config,
                                       device=device)
  pressed_planner.optimize(None, wd0.replace(qpos=pressed_q))
  torch.cuda.synchronize()
  (pressed,) = records.values()
  out = pressed[0](*pressed[2], **pressed[3])
  ground_rows = sum(n for t in range(HORIZON_WALKER_ILQG)
                    for key, n in active_rows(wm, step_lane.contact_gaps(
                        wm, out[t, :wm.nq])).items() if "plane" in key)
  prow = recorded_check("walker_feedback_pressed", pressed, walker, card,
                        witness=True)
  emit("walker_ilqg_path", case="feedback_from_a_pressed_state",
       active_ground_rows=ground_rows, card=card)
  assert ground_rows > 0, ground_rows
  entries.append(rollout_entry(
      "walker_feedback", row, "walker_ilqg_path",
      dict(walker_ilqg_path=launches["rollout"]),
      layout=b1_layout(recorded[0], row["K"]),
      pressed_state=dict(
          active_ground_rows=ground_rows,
          max_abs_err_states=prow["max_abs_err_states"],
          max_err_states_abs_rel=prow["max_err_states_abs_rel"],
          per_candidate=prow["per_candidate"])))
  # B2 at Walker's size: time, plain time and bound on a problem of it
  prob = riccati_problem(HORIZON_WALKER_ILQG, 2 * wm.nv, wm.nu, SEED + 11,
                         False, device)
  reg = torch.tensor(1e-3, device=device)
  rrow = check_riccati(riccati, prob, reg, TOL_RICCATI_ABS)
  rb, ro = riccati_work(2 * wm.nv, wm.nu, HORIZON_WALKER_ILQG,
                        wplanner.config.boxqp_iters)
  rrow.update(kernel_ms=time_cuda(lambda: riccati(*prob, reg), 50),
              plain_ms=host_ms(lambda: riccati.plain(*prob, reg)),
              bytes=rb, flops=ro, bytes_ms=rb / H100_BYTES_PER_S * 1e3,
              ops_ms=ro / H100_F32_FLOPS * 1e3, layout=riccati.layout)
  emit("kernels", case="riccati_walker", ndx=2 * wm.nv, nu=wm.nu,
       T=HORIZON_WALKER_ILQG, card=card, **rrow)
  assert rrow["within_tol"], rrow

  # (c) Walker under the agent: testspeed on the lane sampler, step_env a
  # CUDA graph of the contact pipeline step
  records.clear()
  zero_counts(counters)
  with recording_rollouts(records):
    out = testspeed.run("Walker", total_time=AGENT_WALKER_TIME,
                        steps_per_planning_iteration=AGENT_STEPS_PER_PLAN,
                        verbose=False, device=device, seed=SEED)
  launches = read_counts(counters)
  path_launches["agent_walker"] = launches
  run = out["run"]
  plans = len(run["plan_times"])
  torso_z = run["states"][:, 1] + float(walker.model.body_pos[1, 2])
  sim_s = float(len(run["costs"])) * float(walker.model.opt.timestep)
  # the graph of one step against the eager step, standing on the floor
  agent = Agent(walker)
  qpos = agent.data.qpos.clone()
  qpos[1] -= step_lane.contact_clearance(walker.model, qpos) + 0.002
  agent.data = agent.data.replace(qpos=qpos)
  graph_ms, eager_ms, graph_err = graph_and_eager_step_ms(agent)
  emit("agent_walker", K=K_WALKER_AGENT, H=HORIZON_WALKER_AGENT, P=3,
       simulated_s=sim_s, plans=plans, launches=launches,
       realtime_factor=out["realtime_factor"],
       plan_ms_p50=out["plan_time_p50"] * 1e3,
       plan_ms_p90=out["plan_time_p90"] * 1e3,
       step_ms_mean=out["step_time_mean"] * 1e3, wall_s=out["wall_time"],
       cost_per_simulated_s=float(np.sum(run["costs"])) *
       float(walker.model.opt.timestep) / sim_s,
       avg_cost=out["avg_cost"], torso_height_min=float(torso_z.min()),
       torso_height_last=float(torso_z[-1]), graph_step_ms=graph_ms,
       eager_step_ms=eager_ms, graph_vs_eager_max_abs_err=graph_err,
       routes=out["routes"], card=card)
  assert out["routes"]["planner"] == "LaneSamplingPlanner", out["routes"]
  assert launches["rollout"] == plans + 1 and launches["riccati"] == 0, \
      (launches, plans)
  assert np.isfinite(run["states"]).all() and np.isfinite(run["costs"]).all()
  assert torso_z.min() > TORSO_FLOOR, float(torso_z.min())
  assert graph_err <= TOL_STEP_GRAPH, graph_err
  (recorded,) = records.values()
  row = walker_cost_sums_check("agent_walker_cost_sums", recorded, walker,
                               card)
  entries.append(rollout_entry(
      "walker_cost_sums", row, "agent_walker",
      dict(agent_walker=launches["rollout"]),
      layout=b1_layout(recorded[0], row["K"])))

  # the new sizes of B2, B3 and B4
  entries += [dict(
      name="riccati_lane.backward[walker]", route="cuda",
      source="mujoco_mpc_tpu_torch/ops/csrc/riccati_backward.cu",
      replaces="mujoco_mpc_tpu/ops/riccati_lane.py:58",
      launches=path_launches["walker_ilqg_path"]["riccati"],
      launches_by_path=dict(
          walker_ilqg_path=path_launches["walker_ilqg_path"]["riccati"]),
      max_abs_err=max(rrow["max_abs_err_k"], rrow["max_abs_err_K"]),
      ms=rrow["kernel_ms"], plain_ms=rrow["plain_ms"],
      bound_ms=max(rrow["bytes_ms"], rrow["ops_ms"]),
      bound_by="bytes" if rrow["bytes_ms"] >= rrow["ops_ms"]
      else "operations", library_ms=None,
      shape=dict(ndx=2 * wm.nv, nu=wm.nu, T=HORIZON_WALKER_ILQG)), dict(
      name="scoring.score_fused[gradient_line_search]", route="cuda",
      source="mujoco_mpc_tpu_torch/ops/csrc/score_fused.cu",
      replaces="mujoco_mpc_tpu/ops/scoring.py:47",
      launches=path_launches["gradient_path"]["scoring"],
      launches_by_path=dict(
          gradient_path=path_launches["gradient_path"]["scoring"]),
      max_abs_err=err_score, ms=score_row["graph_ms"],
      device_ms=score_row["device_ms"], call_ms=score_row["call_ms"],
      plain_ms=score_row["plain_ms"],
      bound_ms=max(score_row["bytes_ms"], score_row["ops_ms"]),
      bound_by="bytes" if score_row["bytes_ms"] >= score_row["ops_ms"]
      else "operations", library_ms=None,
      shape=dict(K=score_row["K"], T=score_row["T"])), dict(
      name="cholesky.chol_solve_lanes[gradient_line_search]", route="cuda",
      source="mujoco_mpc_tpu_torch/ops/csrc/chol_solve_lanes.cu",
      replaces="mujoco_mpc_tpu/ops/cholesky.py:66",
      launches=path_launches["gradient_path"]["cholesky"],
      launches_by_path=dict(
          gradient_path=path_launches["gradient_path"]["cholesky"]),
      max_abs_err=chol_row["max_abs_err"], ms=chol_row["graph_ms"],
      device_ms=chol_row["device_ms"], call_ms=chol_row["call_ms"],
      plain_ms=chol_row["plain_ms"],
      bound_ms=max(chol_row["bytes_ms"], chol_row["ops_ms"]),
      bound_by="bytes" if chol_row["bytes_ms"] >= chol_row["ops_ms"]
      else "operations", library_ms=chol_row["library_ms"],
      shape=dict(n=n, K=k))]
  emit("contact_gradient_paths", seconds=time.perf_counter() - t_phase,
       card=card)
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
  if sys.argv[1:] == ["--only", "agent_paths"]:
    # phase 10 alone, its kernels built at first use (for work on it)
    agent_paths(dict(rollout=step_lane, riccati=riccati_lane,
                     scoring=scoring, cholesky=cholesky), {}, card, device)
    print(card, flush=True)
    print(json.dumps({"only": "agent_paths", "ok": True}), flush=True)
    return 0
  if sys.argv[1:] == ["--only", "estimator_paths"]:
    # phase 12 alone, its kernels built at first use
    entries = estimator_paths(
        dict(rollout=step_lane, riccati=riccati_lane, scoring=scoring,
             cholesky=cholesky), {}, card, device)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"only": "estimator_paths", "ok": True}), flush=True)
    return 0
  if sys.argv[1:] == ["--only", "contact_gradient_paths"]:
    # phase 11 alone, its kernels built at first use
    entries = contact_gradient_paths(
        dict(rollout=step_lane, riccati=riccati_lane, scoring=scoring,
             cholesky=cholesky), {}, card, device)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"only": "contact_gradient_paths", "ok": True}),
          flush=True)
    return 0

  phase_mark('build')
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
  walker_built = walker_builds(device)
  kernels.update(walker_built[1])
  riccati[("walker", 0)] = walker_built[2]
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

  phase_mark('3_kernels')
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

  phase_mark('4_main_path')
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

  phase_mark('5_ilqg_path')
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

  phase_mark('6_sampling_family')
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

  phase_mark('7_ground_site_aux')
  # ---- 7. ground contacts, site transmission, per-step aux rows ----
  slice_e_entries = ground_site_aux(e_tasks, kernels, counters, card, device)

  phase_mark('8_body_pairs')
  # ---- 8. body-body contact pairs ----
  slice_f_entries = body_pairs(f_tasks, kernels, f_models, counters, card,
                               device)

  phase_mark('10_agent_paths')
  # ---- 10. the agent loop ----
  agent_entries = agent_paths(counters, path_launches, card, device,
                              main_ms=iter_ms)

  phase_mark('11_contact_gradient_paths')
  # ---- 11. pipeline contacts and the Gradient planner ----
  phase11_entries = contact_gradient_paths(counters, path_launches, card,
                                           device, built=walker_built)

  phase_mark('12_estimator_paths')
  # ---- 12. the estimators and the Direct optimizer ----
  phase12_entries = estimator_paths(counters, path_launches, card, device)

  phase_mark(None)
  emit("timing", seconds_by_phase=PHASE_SECONDS, card=card)
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
  }] + slice_e_entries + slice_f_entries + agent_entries +
      phase11_entries + phase12_entries}), flush=True)
  print(card, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
