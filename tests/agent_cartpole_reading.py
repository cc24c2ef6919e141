"""Reading: how far the JAX package's agent brings Cartpole's cost down in
testspeed, seed by seed.

`chip_smoke.py` phase 10 runs the port's testspeed on Cartpole (the
task's own configuration, K=10, H=101, a plan every 4 steps, 10 simulated
seconds) for seeds 0-2 and compares the mean cost over the last simulated
second with the first second's. This script runs the JAX package's Agent
the same way on the CPU (its pipeline sampling planner; jitted, about 3
minutes with a cold compile cache) and prints one JSON line per seed with
both means and their ratio, and one with the ratio of the seeds' means:
the reference for what K=10 achieves seed by seed.

  JAX_PLATFORMS=cpu python -m tests.agent_cartpole_reading
"""

import json

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from mujoco_mpc_tpu.agent.agent import Agent  # noqa: E402
from mujoco_mpc_tpu.tasks import registry  # noqa: E402

SEEDS = (0, 1, 2)
TOTAL_TIME, STEPS_PER_PLAN = 10.0, 4


def main():
  firsts, lasts = [], []
  for seed in SEEDS:
    task = registry.get_task("Cartpole")
    agent = Agent(task, seed=seed)
    agent.plan_iteration()           # warm up as testspeed does
    agent.step_env()
    agent.reset()
    costs = agent.run(TOTAL_TIME, STEPS_PER_PLAN)["costs"]
    per_s = int(round(1.0 / float(task.model.opt.timestep)))
    first, last = float(costs[:per_s].mean()), float(costs[-per_s:].mean())
    firsts.append(first)
    lasts.append(last)
    print(json.dumps(dict(seed=seed, cost_first_second=first,
                          cost_last_second=last, share=last / first)),
          flush=True)
  print(json.dumps(dict(seeds=list(SEEDS),
                        share_of_means=float(np.mean(lasts) /
                                             np.mean(firsts)))), flush=True)


if __name__ == "__main__":
  main()
