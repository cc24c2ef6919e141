"""Time kernels B2, B3 and B4 of the port on the card, three ways each.

    python3 scripts/torch_kernel_sweep.py [--package-root DIR]
        [--only b4,b2,b3,profile,tune_b2,tune_b3,paths] [--out FILE]
        # needs one GPU

At every shape a path or `chip_smoke.py` hands the kernel:
  * B4, the batched Cholesky solve (`ops/cholesky.py`), at every
    `chip_smoke.CHOL_SIZES` shape, the robust path's (8, 16) among them;
  * B2, the Riccati sweep (`ops/riccati_lane.py`), at Swimmer's iLQG shape
    (ndx 16, nu 5, T 40), at iLQS's T 201, at a quadruped's (36, 12) and at
    the gate's largest (128, 32), regularisation on the control;
  * B3, the fused scoring kernel (`ops/scoring.py`), at the quadruped's cost
    (K 4096, T 36), at the robust path's noisy batch (Swimmer, K 16, T 201:
    its own (K, T, nr) batch through a permuted view, and as (T, nr, K)
    rows) and at the Cartpole lane planner's (K 10, T 101);
it prints, beside the bound `chip_smoke.py` computes (`chol_work`,
`riccati_work`, `score_work`):
  * `chain_ms`: CUDA events around a chain of launches over their count
    (`chip_smoke.time_cuda`); where a launch is shorter than the host's
    time to make it, this reads the host;
  * `device_ms`: the kernel's own time on the card, from `torch.profiler`
    (the summed device time of the kernel's launches over their count);
    for B3 also `device_ms_cold`, with a 64 MB read between calls so that
    the input is not in the 50 MB L2 cache, and `device_kernels`, the
    device kernels one scorer call makes (`chip_smoke.device_kernels`);
  * `host_ms`: host-clock time of one wrapper call, without synchronising
    (what the caller waits for); for B4 also through its vmap rule
    (`torch.func.vmap(cholesky.spd_solve)`), the robust path's way in.
Once a run, `empty`: the device time of an empty kernel (one block of 32
threads, built here from `EMPTY_SOURCE`), the floor of any launch.

`paths`: ilqg_path, robust_path, ilqs_path and cartpole_sampling_path,
the paths that launch B2, B3 or B4, timed as chip_smoke.py times them,
and the stages of an iLQS iteration (its sampler, then its iLQG's
stages; CUDA events). `profile`: B2's build with -DRB_PROFILE=1 at (16,
5, 40) and (128, 32, 40): the mean clock64() cycles of a step and each
phase's mean share of it (stamps of thread 0 after each phase's
barrier). `tune_b2`: B2 at every block size the kernel takes, each
variant built here with its own defines. `tune_b3`: B3 at every tile and
slice count its launcher takes (`B3_TUNE`), through the library's
launcher with those launch arguments (how `scoring.layout` was picked).
`tune` is both.

`--package-root DIR` imports the package from DIR (another checkout, e.g.
a `git archive` of the parent commit unpacked under build/; the timers,
inputs and bounds stay this checkout's `chip_smoke.py`): parent, this
tree, this tree, parent in one call compares the kernels on one card.
Sections an older checkout lacks are skipped; run the tunes on this
checkout only.
Prints one JSON line per measurement and the card's name and power limit;
`--out` also appends them to a file. A measuring tool: nothing in the
package depends on it.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RICCATI_SHAPES = ((16, 5, 40), (16, 5, 201), (36, 12, 40), (128, 32, 40))
PROFILE_SHAPES = ((16, 5, 40), (128, 32, 40))
QP_ITERS = 6
# B3's shapes: task, K, T, and whether the residuals are (T, nr, K) rows
# (the lane planner's) or the pipeline rollouts' (K, T, nr) batch seen
# through a permuted view (robust's)
B3_SHAPES = (("Quadruped Flat", 4096, 36, True), ("Swimmer", 16, 201, False),
             ("Swimmer", 16, 201, True), ("Cartpole", 10, 101, True))
# the layouts `tune_b3` times: tile x slices within 1,024 threads
B3_TUNE = [(tile, slices) for tile in (1, 2, 4, 8, 16, 32)
           for slices in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
           if tile * slices <= 1024]
L2_FLUSH_BYTES = 64 << 20
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
extern "C" __global__ void empty_launch_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_launch_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


class Out:
  def __init__(self, path, root):
    self.path, self.root = path, root

  def __call__(self, section, **kw):
    line = json.dumps(dict(section=section, package_root=self.root, **kw))
    print(line, flush=True)
    if self.path:
      with open(self.path, "a") as f:
        f.write(line + "\n")


def bound(nbytes, flops, cs):
  b_ms = nbytes / cs.H100_BYTES_PER_S * 1e3
  o_ms = flops / cs.H100_F32_FLOPS * 1e3
  return dict(bound_ms=max(b_ms, o_ms),
              bound_by="bytes" if b_ms >= o_ms else "operations")


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--package-root", default=os.path.join(HERE, os.pardir))
  parser.add_argument("--only", default="b4,b2,b3,profile")
  parser.add_argument("--out", default=None)
  a = parser.parse_args()
  if not torch.cuda.is_available():
    print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
    return 1
  root = os.path.abspath(a.package_root)
  sys.path.insert(0, root)
  # the timers, inputs and bounds of this checkout's chip_smoke.py, the
  # package from `root`
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(HERE, os.pardir, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  from mujoco_mpc_tpu_torch.ops import (_build, cholesky,  # noqa: E402
                                        riccati_lane, scoring)
  from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402
  only = set(a.only.split(","))
  if "tune" in only:
    only |= {"tune_b2", "tune_b3"}
  out = Out(a.out, root)
  card = cs.card_line()
  dev = torch.device("cuda")
  rng = np.random.default_rng(0)
  reg = torch.tensor(1e-2, device=dev)

  riccati = {}
  if "b2" in only:
    for ndx, nu, t in RICCATI_SHAPES:
      riccati[(ndx, nu, t)] = riccati_lane.build_backward_kernel(
          ndx, nu, t, QP_ITERS, 0)
  profiled = {}
  if "profile" in only:
    try:
      for ndx, nu, t in PROFILE_SHAPES:
        profiled[(ndx, nu, t)] = riccati_lane.build_backward_kernel(
            ndx, nu, t, QP_ITERS, 0, _profile=True)
    except TypeError:
      out("profile", skipped="this checkout has no RB_PROFILE build")
  tasks = {name: registry.get_task(name, device=dev)
           for name in ("Quadruped Flat", "Swimmer", "Cartpole")}
  tuned = riccati_variants(riccati_lane) if "tune_b2" in only else []

  # every library first, all nvcc runs side by side
  t0 = time.perf_counter()
  procs = {}
  if "b4" in only:
    for n in sorted({n for n, _ in cs.CHOL_SIZES}):
      procs[f"chol_n{n}"] = _build.start_build(
          "chol_solve_lanes.cu", cholesky.build_defines(n))
  for key, kern in list(riccati.items()) + list(profiled.items()):
    procs[f"riccati_{key}"] = _build.start_build(
        "riccati_backward.cu", kern.build_defines())
  if "b3" in only:
    for name, task in tasks.items():
      procs[f"score_{name}"] = _build.start_build(
          "score_fused.cu", scoring.build_defines(task.cost_spec))
  for name, source, defines in tuned:
    procs[name] = _build.start_build(source, defines)
  procs["empty_launch"] = start_empty_build(_build)
  for path, proc in procs.values():
    _build.finish_build(proc)
  out("build", seconds=time.perf_counter() - t0, card=card,
      libraries={k: _build.BUILD_LOG[p] for k, (p, _) in procs.items()})
  empty = empty_launcher(procs["empty_launch"][0])
  out("empty", device_ms=cs.device_ms(empty, 200, "empty_launch_kernel"),
      chain_ms=cs.time_cuda(empty, 200), host_ms=cs.call_ms(empty, 200),
      card=card)

  if "b4" in only:
    for n, k in cs.CHOL_SIZES:
      am, bm = cs.spd_batch(n, k, rng, dev)
      x = cholesky.chol_solve_lanes(am, bm)
      err = float((x - cholesky.chol_solve_lanes_plain(am, bm)).abs().max())
      ab, bb = am.permute(2, 0, 1).contiguous(), bm.T.contiguous()
      solve = torch.func.vmap(cholesky.spd_solve)
      # the vmap rule as a vmapped spd_solve calls it: the batch on dim 0
      # of (n, n, 1) and (n, 1) systems
      info = types.SimpleNamespace(batch_size=k)
      a4, b3 = ab[..., None], bb[..., None]
      rule = lambda: cholesky._LaneSolve.vmap(info, (0, 0), a4, b3)  # noqa
      lib_a, lib_b = ab, bb[..., None]
      out("b4", n=n, K=k, max_abs_err=err,
          chain_ms=cs.time_cuda(lambda: cholesky.chol_solve_lanes(am, bm),
                                200),
          device_ms=cs.device_ms(lambda: cholesky.chol_solve_lanes(am, bm),
                                 100, "chol_solve_lanes"),
          host_ms=cs.call_ms(lambda: cholesky.chol_solve_lanes(am, bm), 200),
          host_ms_rule=cs.call_ms(rule, 200),
          host_ms_vmap=cs.call_ms(lambda: solve(ab, bb), 200),
          library_ms=cs.time_cuda(lambda: torch.linalg.solve(lib_a, lib_b),
                                  50),
          **bound(*cs.chol_work(n, k), cs), card=card)

  if "b2" in only:
    for (ndx, nu, t), kern in riccati.items():
      prob = cs.riccati_problem(t, ndx, nu, seed=7 * ndx + nu,
                                tight_limits=False, device=dev)
      ks, km, _, ok = kern(*prob, reg)
      ks_p, km_p, _, ok_p = kern.plain(*prob, reg)
      err = max(float((ks - ks_p).abs().max()),
                float((km - km_p).abs().max()))
      reps = 20 if ndx >= 128 else 100
      dms = cs.device_ms(lambda: kern(*prob, reg), reps, "riccati_backward")
      defines = kern.build_defines()
      out("b2", ndx=ndx, nu=nu, T=t, max_abs_err=err, ok=bool(ok),
          ok_plain=bool(ok_p), chain_ms=cs.time_cuda(lambda: kern(*prob, reg),
                                                     reps),
          device_ms=dms, host_ms=cs.call_ms(lambda: kern(*prob, reg), reps),
          defines=defines, layout=getattr(kern, "layout", None),
          **bound(*cs.riccati_work(ndx, nu, t, QP_ITERS), cs), card=card)

  for (ndx, nu, t), kern in profiled.items():
    prob = cs.riccati_problem(t, ndx, nu, seed=7 * ndx + nu,
                              tight_limits=False, device=dev)
    kern(*prob, reg)
    kern(*prob, reg)
    torch.cuda.synchronize()
    stamps = kern.last_profile.double().cpu()        # (T-1, stamps)
    phases = stamps[:, 1:] - stamps[:, :-1]
    step = stamps[:, -1] - stamps[:, 0]
    out("profile", ndx=ndx, nu=nu, T=t, steps=int(stamps.shape[0]),
        phases=getattr(riccati_lane, "PROFILE_PHASES", None),
        cycles_per_step=float(step.mean()),
        cycles_per_step_median=float(step.median()),
        phase_cycles=[float(c) for c in phases.mean(dim=0)],
        phase_cycles_median=[float(c) for c in phases.median(dim=0).values],
        phase_cycles_first_step=[float(c) for c in phases[0]],
        phase_share=[float(s) for s in (phases / step[:, None]).mean(dim=0)],
        card=card)

  if "b3" in only:
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    for name, k, t, rows in B3_SHAPES:
      spec = tasks[name].cost_spec
      batch = torch.as_tensor(rng.standard_normal(
          (k, t, spec.num_residual)).astype(np.float32)).to(dev)
      res = batch.permute(1, 2, 0)
      if rows:
        res = res.contiguous()
      scorer = scoring.make_scorer(spec, dev)
      err = float((scorer(res) - scoring.score_reference(batch, spec))
                  .abs().max())

      def cold():
        flush.sum()
        return scorer(res)

      out("b3", task=name, K=k, T=t, nr=spec.num_residual,
          residuals="rows (T, nr, K)" if rows else "batch (K, T, nr) permuted",
          max_abs_err=err, layout=b3_layout(scoring, k, t),
          device_kernels=cs.device_kernels(lambda: scorer(res)),
          chain_ms=cs.time_cuda(lambda: scorer(res), 200),
          device_ms=cs.device_ms(lambda: scorer(res), 200, "score_fused"),
          device_ms_cold=cs.device_ms(cold, 50, "score_fused"),
          host_ms=cs.call_ms(lambda: scorer(res), 200),
          plain_ms=cs.time_cuda(lambda: scoring.score_reference(batch, spec),
                                20),
          **bound(*cs.score_work(spec, t, k), cs), card=card)

  if "tune_b3" in only:
    run_tune_b3(cs, scoring, tasks, out, card, rng, dev)
  if tuned:
    run_tune_b2(cs, _build, riccati_lane, out, card, reg)
  if "paths" in only:
    run_paths(cs, out, card, dev)
  print(card, flush=True)
  return 0


def run_paths(cs, out, card, dev):
  """The paths that launch B2, B3 or B4, as chip_smoke.py drives them (its
  run_path: one warm-up, chained iterations timed with CUDA events,
  launches counted): ilqg_path (Swimmer, H=40, 10 iterations), robust_path
  (Swimmer, H=201, 1 iteration: ~15 s of host dispatch), ilqs_path
  (Swimmer, H=201, 3 iterations) and cartpole_sampling_path (Cartpole,
  K=10, H=101, 10 iterations). Compare parent and tree within one call."""
  from mujoco_mpc_tpu_torch.ops import (cholesky, riccati_lane,  # noqa
                                        sampling_lane, scoring, step_lane)
  from mujoco_mpc_tpu_torch.planners import ilqg, ilqs, robust  # noqa
  from mujoco_mpc_tpu_torch.tasks import registry  # noqa
  counters = dict(rollout=step_lane, riccati=riccati_lane, scoring=scoring,
                  cholesky=cholesky)
  swim = registry.get_task("Swimmer", device=dev)
  cart = registry.get_task("Cartpole", device=dev)
  gen = torch.Generator(device=dev).manual_seed(cs.SEED)
  planners = (
      ("ilqg_path", 10, lambda: ilqg.ILQGPlanner(
          swim, ilqg.make_config(swim).replace(horizon=cs.ILQG_HORIZON),
          device=dev)),
      ("robust_path", 1, lambda: robust.RobustPlanner(swim, device=dev)),
      ("ilqs_path", 3, lambda: ilqs.ILQSPlanner(swim, device=dev)),
      ("cartpole_sampling_path", 10,
       lambda: sampling_lane.LaneSamplingPlanner(cart, device=dev)))
  for name, iterations, make in planners:
    planner = make()
    d0 = (cart if name.startswith("cartpole") else swim).make_data()
    infos, ms, launches, syncs = cs.run_path(planner, d0, iterations,
                                             counters, gen)
    # iLQS's work depends on which planner wins an iteration (a spline fit
    # when iLQG does)
    active = [i["active"] for i in infos if "active" in i] or None
    stages = ilqs_stages(planner, d0, gen) if name == "ilqs_path" else None
    out("paths", path=name, iterations=iterations, ms_per_iteration=ms,
        launches=launches, host_syncs_per_iteration=syncs, active=active,
        stage_ms=stages, card=card)


def ilqs_stages(planner, d0, gen, iterations=3):
  """Mean milliseconds of each stage of an iLQS iteration (its sampler,
  then its iLQG's stages through the planner's `mark` hook), from CUDA
  events recorded at the stage boundaries, over `iterations` more
  iterations after the timed ones."""
  events = []

  def mark(stage):
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    events[-1][stage] = event

  sampler, ilqg_opt = planner.sampler.optimize, planner.ilqg.optimize

  def sampler_marked(g, d):
    mark("iteration")
    result = sampler(g, d)
    mark("sampler")
    return result

  planner.sampler.optimize = sampler_marked
  planner.ilqg.optimize = lambda g, d: ilqg_opt(g, d, mark=mark)
  try:
    for _ in range(iterations):
      events.append({})
      planner.optimize(gen, d0)
      mark("end")
    torch.cuda.synchronize()
  finally:
    planner.sampler.optimize, planner.ilqg.optimize = sampler, ilqg_opt
  names = [n for n in events[0]]
  return {f"{a}->{b}": float(np.mean([e[a].elapsed_time(e[b])
                                       for e in events]))
          for a, b in zip(names, names[1:])}


def b3_layout(scoring, k, t):
  """The launch rule's (tile, slices) on this card; None for a checkout
  without one."""
  if not hasattr(scoring, "layout"):
    return None
  return list(scoring.layout(k, t, scoring.sm_count(
      torch.cuda.current_device())))


def start_empty_build(_build):
  """Start nvcc on EMPTY_SOURCE, written under the build directory;
  returns (library path, process) as `_build.start_build` does."""
  os.makedirs(_build.build_dir(), exist_ok=True)
  src = os.path.join(_build.build_dir(), "empty_launch.cu")
  with open(src, "w") as f:
    f.write(EMPTY_SOURCE)
  return _build.start_build(src, {})   # an absolute path leaves CSRC


def empty_launcher(path):
  fn = ctypes.CDLL(path).empty_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p]
  return lambda: fn(torch.cuda.current_stream().cuda_stream)


def run_tune_b3(cs, scoring, tasks, out, card, rng, dev):
  """B3 at every layout of B3_TUNE at each B3 shape, through the library's
  launcher with those launch arguments; the rule's layout is marked. Where
  the input passes 8 MB, also with it out of L2 (`device_ms_cold`)."""
  flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
  for name, k, t, rows in B3_SHAPES:
    spec = tasks[name].cost_spec
    batch = torch.as_tensor(rng.standard_normal(
        (k, t, spec.num_residual)).astype(np.float32)).to(dev)
    res = batch.permute(1, 2, 0)
    if rows:
      res = res.contiguous()
    want = scoring.score_reference(batch, spec)
    fn_lib = scoring._function(spec)
    stream = torch.cuda.current_stream().cuda_stream
    got = torch.empty((k,), device=dev)
    args = (res.data_ptr(), *res.stride(), spec.weights.data_ptr(),
            spec.weights.stride(0), spec.norm_params.data_ptr(),
            spec.norm_params.stride(0), got.data_ptr(), t, k)
    rule = b3_layout(scoring, k, t)
    for tile, slices in B3_TUNE:
      if tile > 2 * k or slices > 2 * t:
        continue

      def launch(tile=tile, slices=slices):
        assert fn_lib(*args, tile.bit_length() - 1, slices, stream) == 0

      def cold(launch=launch):
        flush.sum()
        launch()

      launch()
      err = float((got - want).abs().max())
      out("tune_b3", task=name, K=k, T=t, rows=rows, tile=tile,
          slices=slices, rule=[tile, slices] == rule,
          max_abs_err=err,
          device_ms=cs.device_ms(launch, 100, "score_fused"),
          device_ms_cold=cs.device_ms(cold, 30, "score_fused")
          if k * t * spec.num_residual * 4 > L2_FLUSH_BYTES // 8 else None,
          card=card)


# the variants `tune_b2` times: B2 at every block size its kernel takes (64
# to 1,024 threads at ndx <= 36, 256 to 1,024 at 128)
def riccati_tune(shapes):
  return [(shape, block) for shape in shapes if shape[2] <= 64
          for block in ((64, 128, 256, 512, 1024) if shape[0] <= 36
                        else (256, 512, 1024))]


def riccati_variants(riccati_lane):
  """(name, source, defines) of every variant `tune_b2` builds."""
  out = []
  for (ndx, nu, t), block in riccati_tune(RICCATI_SHAPES):
    kern = riccati_lane.build_backward_kernel(ndx, nu, t, QP_ITERS, 0)
    out.append((f"riccati_{ndx}_{nu}_{t}_b{block}", "riccati_backward.cu",
                dict(kern.build_defines(), RB_BLOCK=block)))
  return out


def riccati_variant(_build, defines):
  """fn(*prob, reg) -> (ks, kmats) launching the Riccati library built with
  `defines`."""
  fn = _build.load("riccati_backward.cu", defines).riccati_backward
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 15

  def backward(*args):
    t, nu = args[3].shape
    ndx = args[2].shape[1]
    ks = torch.empty((t - 1, nu), device=args[0].device)
    kmats = torch.empty((t - 1, nu, ndx), device=args[0].device)
    out = torch.empty(3, device=args[0].device)
    assert fn(*[x.data_ptr() for x in args], ks.data_ptr(), kmats.data_ptr(),
              out.data_ptr(), None,
              torch.cuda.current_stream().cuda_stream) == 0
    return ks, kmats
  return backward


def run_tune_b2(cs, _build, riccati_lane, out, card, reg):
  for (ndx, nu, t), block in riccati_tune(RICCATI_SHAPES):
    kern = riccati_lane.build_backward_kernel(ndx, nu, t, QP_ITERS, 0)
    fn_lib = riccati_variant(_build, dict(kern.build_defines(),
                                          RB_BLOCK=block))
    prob = cs.riccati_problem(t, ndx, nu, seed=7 * ndx + nu,
                              tight_limits=False, device=reg.device)
    ks, km = fn_lib(*prob, reg)
    ks_p, km_p, _, _ = kern.plain(*prob, reg)
    err = max(float((ks - ks_p).abs().max()), float((km - km_p).abs().max()))
    reps = 20 if ndx >= 128 else 100
    out("tune_b2", ndx=ndx, nu=nu, T=t, block=block, max_abs_err=err,
        chain_ms=cs.time_cuda(lambda: fn_lib(*prob, reg), reps),
        device_ms=cs.device_ms(lambda: fn_lib(*prob, reg), reps,
                               "riccati_backward"), card=card)


if __name__ == "__main__":
  sys.exit(main())
