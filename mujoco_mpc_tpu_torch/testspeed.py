"""Headless synchronous planning benchmark (the reference's
mjpc/testspeed.{h,cc}).

Runs the plan/act loop for `total_time` simulated seconds, planning every
`steps_per_planning_iteration` physics steps, and reports the wall time,
the realtime factor, the average cost per step and the median planning
latency. Usage:

    python -m mujoco_mpc_tpu_torch.testspeed --task Cartpole --total_time 10

On a machine without a card, add `--device cpu` (the pipeline planners and
the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def run(task_name: str, total_time: float = 10.0,
        steps_per_planning_iteration: int = 4, planner: str = None,
        verbose: bool = True, device="cuda", seed: int = 0) -> dict:
  """The benchmark on `device`. Returns the reference's keys (task,
  planner, total_time, wall_time, realtime_factor, avg_cost, plan_time_p50)
  and plan_time_p90, step_time_mean (seconds), the agent's routes and its
  run's time series ("run")."""
  from mujoco_mpc_tpu_torch.agent.agent import Agent
  from mujoco_mpc_tpu_torch.tasks import registry

  task = registry.get_task(task_name, device=device)
  agent = Agent(task, planner=planner, seed=seed)

  # warm up outside the timed window: kernels load, the allocator fills
  agent.plan_iteration()
  agent.step_env()
  agent.reset()
  if agent.device.type == "cuda":
    torch.cuda.synchronize(agent.device)

  start = time.perf_counter()
  out = agent.run(total_time=total_time,
                  steps_per_plan=steps_per_planning_iteration)
  wall = time.perf_counter() - start

  plan_times = out["plan_times"]
  result = {
      "task": task_name,
      "planner": agent.planner_name,
      "total_time": total_time,
      "wall_time": wall,
      "realtime_factor": total_time / wall,
      "avg_cost": out["avg_cost"],
      "plan_time_p50": float(np.median(plan_times))
      if len(plan_times) else 0.0,
      "plan_time_p90": float(np.percentile(plan_times, 90))
      if len(plan_times) else 0.0,
      "step_time_mean": float(np.mean(out["step_times"])),
      "routes": agent.routes,
      "run": out,
  }
  if verbose:
    print(f"task: {result['task']}  planner: {result['planner']} "
          f"({agent.routes['planner']})")
    print(f"simulated {total_time:.1f} s in {wall:.2f} s wall "
          f"({result['realtime_factor']:.2f} x realtime)")
    print(f"average cost per step: {result['avg_cost']:.4f}")
    print(f"p50 planning latency: {result['plan_time_p50'] * 1e3:.2f} ms")
  return result


def main():
  p = argparse.ArgumentParser()
  p.add_argument("--task", default="Cartpole")
  p.add_argument("--planner", default=None)
  p.add_argument("--total_time", type=float, default=10.0)
  p.add_argument("--steps_per_planning_iteration", type=int, default=4)
  p.add_argument("--device", default="cuda")
  p.add_argument("--seed", type=int, default=0)
  args = p.parse_args()
  run(args.task, args.total_time, args.steps_per_planning_iteration,
      args.planner, device=args.device, seed=args.seed)


if __name__ == "__main__":
  main()
