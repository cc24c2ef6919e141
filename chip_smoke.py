#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (built for Hopper, sm_90a) and the CUDA toolkit's
`nvcc`; takes no arguments. It

  1. `device`  — fails unless a CUDA device is present; prints the card's
     name and power limit as `nvidia-smi` gives them;
  2. `build`   — compiles every CUDA kernel of the main path (and the two
     other output modes of the rollout kernel) from ops/csrc/, all `nvcc`
     processes side by side, and prints seconds, registers and spills;
  3. `kernels` — runs each kernel's wrapper on CUDA tensors and holds the
     result against the kernel's plain PyTorch version on the same inputs
     (made from a numpy seed), with the tolerances stated below; on the
     contact-rich inputs of the main path the comparison is step by step,
     beside a control (the plain version against itself, its input
     perturbed in the last bits) measured in the same run;
  4. `main_path` — builds the Quadruped Flat task and the predictive
     sampling planner (K=4096 candidates, horizon 36, 3 spline points)
     through the entry points a user calls, runs 1 warm-up + 20 chained
     planner iterations on the card, and checks launches and returns;
  5. prints one JSON line describing every kernel, the card line, and
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
ITERATIONS = 20

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
  from mujoco_mpc_tpu_torch.ops import _build, sampling_lane, step_lane
  from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
  from mujoco_mpc_tpu_torch.planners import sampling
  from mujoco_mpc_tpu_torch.spline import Interpolation
  from mujoco_mpc_tpu_torch.tasks import registry

  assert torch.backends.cuda.matmul.allow_tf32 is False
  rng = np.random.default_rng(SEED)

  # ---- 2. build: every specialisation, all nvcc processes side by side --
  quad = registry.get_task("Quadruped Flat", device=device)
  cart = registry.get_task("Cartpole", device=device)
  spec = quad.lane_residual_spec()
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
  }
  t0 = time.perf_counter()
  procs = {name: _build.start_build("lane_rollout.cu", k.build_defines())
           for name, k in kernels.items()}
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

  # ---- 5. summary lines ----
  print(json.dumps({"kernels": [{
      "name": "step_lane.rollout",
      "route": "cuda",
      "source": "mujoco_mpc_tpu_torch/ops/csrc/lane_rollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/step_lane.py:184",
      "launches": launches,
      "max_abs_err": err_ret,
      "ms": kernel_ms,
      "plain_ms": plain_ms,
      "bound_ms": bound_ms,
      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      "library_ms": None,
  }]}), flush=True)
  print(card, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
