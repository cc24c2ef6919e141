"""Time the lane rollout CUDA kernel's builds and launch layouts on the card.

    python3 scripts/torch_lane_sweep.py            # needs one NVIDIA GPU
    python3 scripts/torch_lane_sweep.py --builds [--package-root DIR]

Default (the sweep): builds ops/csrc/lane_rollout.cu for Rubik (BASELINE
config 5: K=512, H=16), Humanoid Track (config 4: K=512, H=25) and Quadruped
Flat (the main path: K=4096, H=36) in cost-sum mode at every team size
(LR_TEAM 4 / 8 / 16 / 32 lanes a candidate), all `nvcc` runs side by side,
and times each with CUDA events on the planner's own kind of inputs (home
pose, the initial policy plus the task's exploration noise): first at the
wrapper's teams per block, then, for each team size, at 1 / 2 / 4 / 8 / 16
teams a block where the block's threads and shared memory allow. The
quadruped is also timed at K from 1024 to 16384. The rule in
`step_lane.team_size` / `teams_per_block` comes from these times.

`--builds`: the launch time of every rollout build a path of chip_smoke.py
runs, at that path's shape, with the wrapper's defaults. With
`--package-root DIR` the package is imported from DIR (another checkout,
e.g. a `git archive` of the parent commit) instead of this one: running
parent, this tree, this tree, parent in one call compares the two kernels
on one card.

Prints one JSON line per measurement (milliseconds per launch, the build's
registers, stack and spill from `ptxas -v`) and the card's name and power
limit. A measuring tool: nothing in the package depends on it.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _import(package_root):
  """The package and chip_smoke.py's helpers from `package_root`."""
  sys.path.insert(0, package_root)
  import chip_smoke  # noqa: E402  (input makers and timer)
  from mujoco_mpc_tpu_torch.ops import _build, step_lane  # noqa: E402
  from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE  # noqa: E402
  from mujoco_mpc_tpu_torch.planners import sampling  # noqa: E402
  from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402
  return chip_smoke, _build, step_lane, GEOM_SPHERE, sampling, registry


# (key, task, K, H, cost sums or states or feedback, extra build options):
# every rollout build a path of chip_smoke.py launches, at its shape
PATH_BUILDS = (
    ("quadruped", "Quadruped Flat", 4096, 36, "cost_sums", "feet"),
    ("swimmer_feedback", "Swimmer", 8, 40, "feedback", None),
    ("swimmer_cost_sums_h201", "Swimmer", 10, 201, "cost_sums", None),
    ("cartpole_states", "Cartpole", 10, 101, "states", None),
    ("humanoid_track", "Humanoid Track", 512, 25, "cost_sums", None),
    ("humanoid_stand", "Humanoid Stand", 512, 25, "cost_sums", None),
    ("quadrotor", "Quadrotor", 30, 61, "cost_sums", None),
    ("rubik", "Rubik", 512, 16, "cost_sums", "body"),
    ("cube_solving", "Cube Solving", 512, 16, "cost_sums", "body"),
    ("hand_reorient", "Hand Reorient", 512, 16, "cost_sums", "body"),
)


class Sweep:
  def __init__(self, package_root):
    (self.cs, self.build, self.step_lane, self.sphere, self.sampling,
     self.registry) = _import(package_root)
    self.card = self.cs.card_line()
    self.rng = np.random.default_rng(0)

  def config(self, task, k, h):
    cfg = self.sampling.make_config(task)
    return dataclasses.replace(cfg, num_trajectory=k, horizon=h)

  def kernel(self, task, cfg, mode, extra, **opts):
    kw = dict(opts)
    if extra == "feet":
      kw.update(contact_types=(self.sphere,),
                contact_geoms=task.plan_contact_geoms)
    elif extra == "body":
      kw.update(contact_geoms=getattr(task, "plan_contact_geoms", None),
                body_pairs=True,
                body_pair_types=getattr(task, "plan_body_pair_types", None))
    if mode == "states":
      return self.step_lane.build_rollout_kernel(
          task.plan_model, cfg.horizon, cfg.num_spline_points, **kw)
    spec = task.lane_residual_spec(horizon=cfg.horizon) \
        if task.name == "Humanoid Track" else task.lane_residual_spec()
    if mode == "feedback":
      return self.step_lane.build_rollout_kernel(
          task.plan_model, cfg.horizon, 1, residual=spec,
          naux=spec["naux"], record_states=True, feedback=True, **kw)
    terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
    return self.step_lane.build_rollout_kernel(
        task.plan_model, cfg.horizon, cfg.num_spline_points, residual=spec,
        naux=spec["naux"], record_states=False, cost_terms=terms, **kw)

  def inputs(self, task, cfg, mode, k=None):
    """The planner's kind of inputs: home pose, the initial policy plus
    the task's exploration noise (feedback: random gains around the home
    pose, as the iLQG check of chip_smoke.py makes them). Quadruped Flat
    takes chip_smoke.py's main-path inputs instead: the home posture as
    the nominal plus noise, on which it stands with its four feet on the
    floor in every step (the initial policy's mid-range controls make it
    fold and leave the floor in most steps)."""
    k = k or cfg.num_trajectory
    dev = torch.device("cuda")
    if task.name == "Quadruped Flat" and mode == "cost_sums":
      terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
      return self.cs.make_quadruped_inputs(
          task, task.lane_residual_spec(), terms, k, self.rng, dev)
    d0 = task.make_data()
    qpos = d0.qpos[:, None].repeat(1, k).contiguous()
    qvel = d0.qvel[:, None].repeat(1, k).contiguous()
    m = task.plan_model
    if mode == "feedback":
      nu, nv, nq = m.nu, m.nv, m.nq
      blocks = np.concatenate([
          self.rng.uniform(-0.8, 0.8, (cfg.horizon, nu)),
          0.3 * self.rng.standard_normal((cfg.horizon, nu)),
          0.05 * self.rng.standard_normal((cfg.horizon, nu * 2 * nv)),
          np.concatenate([d0.qpos.cpu().numpy(), np.zeros(nv)])[None]
          .repeat(cfg.horizon, 0)], axis=1).astype(np.float32)
      table = torch.as_tensor(blocks.reshape(-1).copy()).to(dev)
      values = torch.as_tensor(self.rng.uniform(0, 1, (2, k)).astype(
          np.float32)).to(dev)
      spec = task.lane_residual_spec()
      aux = self.cs.lane_aux(task, spec, d0, k, None)
      return (qpos, qvel, values, aux, table)
    values = self.cs.planner_candidates(
        task, k, cfg.num_spline_points, cfg.exploration[0], self.rng, dev)
    if mode == "states":
      return (qpos, qvel, values)
    spec = task.lane_residual_spec(horizon=cfg.horizon) \
        if task.name == "Humanoid Track" else task.lane_residual_spec()
    terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
    return (qpos, qvel, values, self.cs.lane_aux(task, spec, d0, k, terms))

  def build_all(self, kernels):
    t0 = time.perf_counter()
    procs = {n: self.build.start_build("lane_rollout.cu", k.build_defines())
             for n, k in kernels.items()}
    for _, (_, proc) in procs.items():
      self.build.finish_build(proc)
    print(json.dumps(dict(phase="build", builds=len(kernels),
                          seconds=round(time.perf_counter() - t0, 1))),
          flush=True)
    return {n: self.build.BUILD_LOG[path]["ptxas"]
            for n, (path, _) in procs.items()}

  def time(self, kern, args, reps):
    out = kern(*args)
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    finite = all(bool(torch.isfinite(o).any()) for o in outs)
    return self.cs.time_cuda(lambda: kern(*args), reps), finite

  def builds(self, reps):
    kernels, cases = {}, {}
    for key, name, k, h, mode, extra in PATH_BUILDS:
      task = self.registry.get_task(name, device="cuda")
      cfg = self.config(task, k, h)
      kernels[key] = self.kernel(task, cfg, mode, extra)
      cases[key] = (task, cfg, mode)
    ptxas = self.build_all(kernels)
    for key, kern in kernels.items():
      task, cfg, mode = cases[key]
      ms, finite = self.time(kern, self.inputs(task, cfg, mode), reps)
      print(json.dumps(dict(case="build", build=key, K=cfg.num_trajectory,
                            H=cfg.horizon, ms=ms, outputs_finite=finite,
                            ptxas=ptxas[key], card=self.card)), flush=True)

  def sweep(self, reps, keys):
    step_lane = self.step_lane
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tasks = {key: (self.registry.get_task(name, device="cuda"), k, h, extra)
             for key, name, k, h, _, extra in PATH_BUILDS
             if key in keys}
    kernels = {}
    for key, (task, k, h, extra) in tasks.items():
      cfg = self.config(task, k, h)
      for team in (4, 8, 16, 32):
        kernels[(key, team)] = self.kernel(task, cfg, "cost_sums", extra,
                                           _team=team)
    ptxas = self.build_all(kernels)
    args = {key: self.inputs(task, self.config(task, k, h), "cost_sums")
            for key, (task, k, h, extra) in tasks.items()}
    for (key, team), kern in kernels.items():
      task, k, h, extra = tasks[key]
      lib = kern.library()
      rule = step_lane.teams_per_block(k, team, lib.lane_smem_bytes, n_sm)
      for tpb in sorted({rule, 1, 2, 4, 8, 16}):
        if tpb * team > step_lane.MAX_THREADS or \
            lib.lane_smem_bytes(tpb) > step_lane.SMEM_MAX:
          continue
        variant = self.kernel(task, self.config(task, k, h), "cost_sums",
                              extra, _team=team, _teams_per_block=tpb)
        ms, finite = self.time(variant, args[key], reps)
        print(json.dumps(dict(
            case="sweep", build=key, K=k, H=h, team=team,
            teams_per_block=tpb, wrapper_rule=tpb == rule,
            smem_bytes=lib.lane_smem_bytes(tpb), ms=ms,
            outputs_finite=finite, ptxas=ptxas[(key, team)],
            card=self.card)), flush=True)
    if "quadruped" not in tasks:
      return
    task, _, h, extra = tasks["quadruped"]
    for k in (1024, 2048, 4096, 8192, 16384):
      cfg = self.config(task, k, h)
      kern = self.kernel(task, cfg, "cost_sums", extra)
      ms, _ = self.time(kern, self.inputs(task, cfg, "cost_sums"), reps)
      print(json.dumps(dict(case="k_sweep", build="quadruped", K=k, H=h,
                            team=kern.library().lane_team(), ms=ms,
                            rollouts_per_s=k / (ms * 1e-3), card=self.card)),
            flush=True)


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--builds", action="store_true",
                      help="time every path's build at its shape")
  parser.add_argument("--package-root", default=os.path.join(HERE, os.pardir),
                      help="checkout to import the package from")
  parser.add_argument("--reps", type=int, default=10)
  parser.add_argument("--tasks", default="rubik,humanoid_track,quadruped",
                      help="the sweep's builds (comma-separated keys)")
  a = parser.parse_args()
  if not torch.cuda.is_available():
    print("torch_lane_sweep: no CUDA device available", file=sys.stderr)
    return 1
  sweep = Sweep(os.path.abspath(a.package_root))
  print(json.dumps(dict(package_root=os.path.abspath(a.package_root))),
        flush=True)
  if a.builds:
    sweep.builds(a.reps)
  else:
    sweep.sweep(a.reps, a.tasks.split(","))
  print(sweep.card)
  return 0


if __name__ == "__main__":
  sys.exit(main())
