#!/usr/bin/env python3
"""Where one iLQG iteration of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_ilqg_profile.py [--task Swimmer] [--horizon 40]

Needs one NVIDIA GPU and `nvcc` (the kernels build at first use). Builds
the task and `ILQGPlanner` as a user would, runs a warm-up iteration, then

  * times a few chained iterations and their four stages with CUDA events
    recorded at the stage boundaries (the planner's `mark` hook);
  * traces one more iteration with `torch.profiler` and prints how many
    kernels it launched, the sum of their device time (the card's busy
    time), the host time of the iteration and the busiest kernels by name.

The device's idle share is 1 - busy / (host time of the traced iteration),
so it covers the traced iteration only, which the profiler slows down.
Prints one JSON line
per block; the card's name and power limit are in each.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--task", default="Swimmer")
  ap.add_argument("--horizon", type=int, default=40)
  ap.add_argument("--iterations", type=int, default=5)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("no CUDA device available", file=sys.stderr)
    return 1
  from mujoco_mpc_tpu_torch.planners import ilqg
  from mujoco_mpc_tpu_torch.tasks import registry

  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  task = registry.get_task(args.task, device="cuda")
  config = ilqg.make_config(task).replace(horizon=args.horizon)
  planner = ilqg.ILQGPlanner(task, config, device="cuda")
  d0 = task.make_data()
  planner.optimize(None, d0)
  torch.cuda.synchronize()

  events = []                      # one {stage: event} per iteration

  def mark(stage):
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    events[-1][stage] = event

  t0 = time.perf_counter()
  for _ in range(args.iterations):
    events.append({})
    planner.optimize(None, d0, mark=mark)
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / args.iterations
  names = ("start", "nominal_line_search", "derivatives", "backward",
           "action_line_search")
  stage_ms = {n: float(np.mean([e[prev].elapsed_time(e[n]) for e in events]))
              for prev, n in zip(names, names[1:])}
  print(json.dumps(dict(
      block="stages", task=args.task, horizon=args.horizon,
      routes=planner.routes, ms_per_iteration=wall_ms,
      stage_ms=stage_ms, card=card)), flush=True)

  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    planner.optimize(None, d0)
    torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.device_time for e in kernels) / 1e3
  by_name = {}
  for e in kernels:
    n, t = by_name.get(e.name, (0, 0.0))
    by_name[e.name] = (n + 1, t + e.device_time / 1e3)
  top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
  print(json.dumps(dict(
      block="trace", traced_iteration_ms=traced_ms,
      device_kernels=len(kernels), device_busy_ms=busy_ms,
      device_idle_share=1.0 - busy_ms / traced_ms if kernels else None,
      top_kernels=[dict(name=k[:80], launches=n, ms=t) for k, (n, t) in top],
      card=card)), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
