#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (built for Hopper, sm_90a) and the CUDA toolkit's
`nvcc`; takes no arguments. It

  1. `device`  — fails unless a CUDA device is present; prints the card's
     name and power limit as `nvidia-smi` gives them;
  2. `build`   — compiles every CUDA kernel of the two paths below (the
     rollout kernel in its three output modes and in its feedback mode with
     fluid, the Riccati kernel at every size and regularisation checked
     here) from ops/csrc/, all `nvcc` processes side by side, and prints
     seconds, registers and spills;
  3. `kernels` — runs each kernel's wrapper on CUDA tensors and holds the
     result against the kernel's plain PyTorch version on the same inputs
     (made from a numpy seed), with the tolerances stated below; on the
     contact-rich inputs of the main path the comparison is step by step,
     beside a control (the plain version against itself, its input
     perturbed in the last bits) measured in the same run;
  4. `main_path` — builds the Quadruped Flat task and the predictive
     sampling planner (K=4096 candidates, horizon 36, 3 spline points)
     through the entry points a user calls, runs 1 warm-up + 10 chained
     planner iterations on the card, and checks launches and returns;
  5. `ilqg_path` — builds the Swimmer task and the iLQG planner (horizon
     40, 4 feedback scales, 8 alphas) the same way, runs 1 warm-up + 10
     chained iterations from the same state, and checks the launches of
     the Riccati kernel and of the rollout kernel's feedback mode, the
     returns, and prints the time of each stage; then runs the same
     iterations once more, outside the timed and counted window, with both
     kernels held against their plain versions on the very inputs the
     planner hands them (the derivatives' rank-deficient Gauss-Newton
     Hessians, the regularisation as the schedule swings it, the gains the
     backward sweep computed);
  6. prints one JSON line describing every kernel, the card line, and
     `{"ok": true, ...}` as the last line.

Any failure raises, so the process exits non-zero. Nothing here imports
JAX or the JAX package.
"""

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
  from mujoco_mpc_tpu_torch.ops import (_build, riccati_lane, sampling_lane,
                                        step_lane)
  from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
  from mujoco_mpc_tpu_torch.planners import ilqg, sampling
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
  t0 = time.perf_counter()
  procs = {name: _build.start_build("lane_rollout.cu", k.build_defines())
           for name, k in kernels.items()}
  procs.update({
      f"riccati_{name}_reg{rt}": _build.start_build(
          "riccati_backward.cu", k.build_defines())
      for (name, rt), k in riccati.items()})
  for name, (path, proc) in procs.items():
    _build.finish_build(proc)
  build_s = time.perf_counter() - t0
  emit("build", seconds=round(build_s, 2), dir=_build.build_dir(),
       libraries={name: dict(_build.BUILD_LOG[path])
                  for name, (path, _) in procs.items()})

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
       plain_ms=riccati_plain_ms, bytes=r_bytes, flops=r_flops,
       bytes_ms=riccati_bytes_ms, ops_ms=riccati_ops_ms,
       dependent_steps=ILQG_HORIZON - 1, card=card)

  # (g) the same kernel at a quadruped's size, at the gate's largest size
  # (workspace in global memory) and at Swimmer's own default horizon
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
        kernel_ms=ms, workspace_in_shared_memory=bool(
            kern.build_defines()["RB_SMEM"]),
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
  launches = step_lane.launch_count
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
  checked_infos = [checked.optimize(None, d0) for _ in range(ILQG_ITERATIONS)]
  torch.cuda.synchronize()
  emit("ilqg_path", case="kernels_on_the_planners_inputs",
       iterations=ILQG_ITERATIONS, seconds=time.perf_counter() - t0,
       riccati=riccati_checks, rollout_max_abs_err=rollout_errs,
       best_return=[float(i["best_return"]) for i in checked_infos],
       tol_riccati_abs=TOL_RICCATI_ABS, tol_riccati_rel=TOL_RICCATI_REL,
       tol_vs_plain32=TOL_RICCATI_VS_PLAIN32, tol_states=TOL_STATES_SWIMMER)
  assert len(riccati_checks) == sum(sweeps), (len(riccati_checks), sweeps)
  assert len(rollout_errs) == 2 * ILQG_ITERATIONS
  assert all(r["passes"] for r in riccati_checks), riccati_checks
  assert max(rollout_errs) <= TOL_STATES_SWIMMER, rollout_errs
  assert np.allclose([float(i["best_return"]) for i in checked_infos], best,
                     rtol=1e-5)

  # ---- 6. summary lines ----
  csrc = "mujoco_mpc_tpu_torch/ops/csrc/"
  print(json.dumps({"kernels": [{
      "name": "step_lane.rollout",
      "route": "cuda",
      "source": csrc + "lane_rollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/step_lane.py:184",
      "launches": launches,
      "max_abs_err": err_ret,
      "ms": kernel_ms,
      "plain_ms": plain_ms,
      "bound_ms": bound_ms,
      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      "library_ms": None,
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
  }, {
      "name": "riccati_lane.backward",
      "route": "cuda",
      "source": csrc + "riccati_backward.cu",
      "replaces": "mujoco_mpc_tpu/ops/riccati_lane.py:58",
      "launches": riccati_launches,
      "max_abs_err": err_riccati,
      "ms": riccati_ms,
      "plain_ms": riccati_plain_ms,
      "bound_ms": max(riccati_bytes_ms, riccati_ops_ms),
      "bound_by": "bytes" if riccati_bytes_ms >= riccati_ops_ms
                  else "operations",
      "library_ms": None,
  }]}), flush=True)
  print(card, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
