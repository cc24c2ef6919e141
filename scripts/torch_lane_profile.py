"""Where a team of the lane rollout kernel spends its cycles, and how many
constraint rows the cull keeps.

    python3 scripts/torch_lane_profile.py [--task quadruped|rubik|humanoid_track]
                                          [--package-root DIR]

Needs one NVIDIA GPU. Builds the task's path specialisation of
ops/csrc/lane_rollout.cu (cost-sum mode at the path's shape: Quadruped Flat
K=4096 H=36, Rubik K=512 H=16, Humanoid Track K=512 H=25) with its section
counters compiled in (`LR_PROFILE=1`): lane 0 of every team counts the
`clock64()` cycles of every section of every step, and every team adds its
step's active scalar rows and elliptic blocks (after the cull) to
counters. Runs it on the planner's own kind of inputs (home pose, the
initial policy plus exploration noise) and prints the launch time of the
instrumented build, the mean cycles of a candidate (and the slowest
candidate's), each section's share and mean cycles per step, and the
active rows per candidate and step (mean, maximum), then the card's name
and power limit.

With `--package-root DIR` the package is imported from DIR (a `git archive`
of an earlier commit): the one-thread-per-candidate kernel from before the
redesign reports its own sections, for candidate 0's thread only (its warp
of 32 candidates runs in step), and no row counts. A measuring tool:
nothing in the package depends on it.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_lane_sweep import PATH_BUILDS, Sweep  # noqa: E402

SECTIONS = {
    0: "control + forward kinematics", 1: "com quantities",
    2: "inertias + motion subspaces", 3: "mass matrix",
    4: "velocities + RNE", 5: "passive + actuation",
    6: "task residual + cost/outputs", 7: "cull (gaps)",
    8: "rows (Jacobians)", 9: "unconstrained solve",
    10: "Newton: row passes", 11: "Newton: gradient + Hessian",
    12: "Newton: Cholesky solve", 13: "Newton: line search",
    14: "constraint force", 15: "implicit Euler + integration",
    19: "prologue"}
# the one-thread kernel's sections (before the redesign)
SECTIONS_ONE_THREAD = {
    0: "forward kinematics", 1: "com quantities", 2: "spatial inertias",
    3: "motion subspaces", 4: "mass matrix", 5: "velocities + RNE bias",
    6: "passive + actuation", 7: "task residual + cost/outputs",
    8: "constraint rows", 9: "unconstrained solve + Newton bookkeeping",
    10: "Newton: limit/pyramid rows", 11: "Newton: elliptic blocks",
    12: "Newton: Cholesky solves", 13: "Newton: line search",
    14: "constraint force", 15: "implicit Euler + integration",
    19: "prologue"}
TASKS = ("quadruped", "rubik", "humanoid_track")


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--task", choices=TASKS, default="quadruped")
  parser.add_argument("--package-root", default=os.path.join(HERE, os.pardir))
  a = parser.parse_args()
  if not torch.cuda.is_available():
    print("torch_lane_profile: no CUDA device available", file=sys.stderr)
    return 1
  sw = Sweep(os.path.abspath(a.package_root))
  teams = hasattr(sw.step_lane, "team_size")
  key, name, k, h, mode, extra = [b for b in PATH_BUILDS if b[0] == a.task][0]
  task = sw.registry.get_task(name, device="cuda")
  cfg = sw.config(task, k, h)
  kern = sw.kernel(task, cfg, mode, extra, _profile=True)
  args = sw.inputs(task, cfg, mode)
  ms = sw.cs.time_cuda(lambda: kern(*args), 5)
  lib = sw.build.load("lane_rollout.cu", kern.build_defines())
  buf = (ctypes.c_ulonglong * 26)()

  def read():
    err = lib.lane_profile(buf)
    if err != 0:
      raise RuntimeError(f"lane_profile failed: CUDA error {err}")
    return list(buf)

  before = read()
  kern(*args)
  torch.cuda.synchronize()
  after = read()
  cycles = [x - y for x, y in zip(after, before)]
  sections = SECTIONS if teams else SECTIONS_ONE_THREAD
  # per candidate: the teams' sums over K (one thread's before)
  per = k if teams else 1
  cycles = [c / per for c in cycles]
  total = sum(cycles[s] for s in sections)
  line = dict(task=task.name, K=k, H=h, instrumented_ms=ms,
              cycles_per_candidate=total, cycles_per_step=total / h,
              package_root=os.path.abspath(a.package_root), card=sw.card)
  if teams:
    steps = h
    line.update(team=kern.build_defines()["LR_TEAM"],
                slowest_candidate_cycles=after[25],
                rows_per_candidate_step=cycles[20] / steps,
                rows_max=after[21],
                blocks_per_candidate_step=cycles[22] / steps,
                blocks_max=after[23],
                share_of_steps_with_rows=cycles[24] / steps,
                rows_if_all_active=2 * kern.build_defines()["LR_NLIMJ"] +
                kern.build_defines()["LR_NPROW"],
                blocks_if_all_active=kern.build_defines()["LR_NECON"])
  print(json.dumps(line), flush=True)
  for slot, label in sections.items():
    print(json.dumps(dict(section=label, cycles=cycles[slot],
                          share=round(cycles[slot] / max(total, 1), 4),
                          cycles_per_step=round(cycles[slot] / h))),
          flush=True)
  print(sw.card)
  return 0


if __name__ == "__main__":
  sys.exit(main())
