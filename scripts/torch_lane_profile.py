"""Where one thread of the lane rollout kernel spends its cycles.

    python3 scripts/torch_lane_profile.py          # needs one NVIDIA GPU

Builds the flagship specialisation of ops/csrc/lane_rollout.cu (Quadruped
Flat, cost-sum mode, K=4096, horizon 36, 3 spline points, feet-only
contacts) with its section counters compiled in (`LR_PROFILE=1`): candidate
0 adds the `clock64()` cycles of every section of every step to a device
array. The kernel's time is one thread's latency through the horizon (one
warp per SM at this K), so that thread's cycles are the kernel's time.
Prints the launch time of the instrumented build, then cycles, share and
cycles per step for each section, and the card's name and power limit.
A measuring tool: nothing in the package depends on it.
"""

import ctypes
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import chip_smoke  # noqa: E402  (input maker and timer)
from mujoco_mpc_tpu_torch.ops import _build, step_lane  # noqa: E402
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402

HORIZON, P, K = 36, 3, 4096
SECTIONS = {
    0: "forward kinematics", 1: "com quantities", 2: "spatial inertias",
    3: "motion subspaces", 4: "mass matrix", 5: "velocities + RNE bias",
    6: "passive + actuation", 7: "task residual + cost/outputs",
    8: "constraint rows", 9: "unconstrained solve + Newton bookkeeping",
    10: "Newton: limit/pyramid rows", 11: "Newton: elliptic blocks",
    12: "Newton: Cholesky solves", 13: "Newton: line search",
    14: "constraint force", 15: "implicit Euler + integration",
    19: "prologue"}


def main():
  if not torch.cuda.is_available():
    print("torch_lane_profile: no CUDA device available", file=sys.stderr)
    return 1
  card = chip_smoke.card_line()
  quad = registry.get_task("Quadruped Flat", device="cuda")
  spec = quad.lane_residual_spec()
  cost_terms = tuple(zip(quad.cost_spec.norm_types, quad.cost_spec.dims))
  kern = step_lane.build_rollout_kernel(
      quad.plan_model, HORIZON, P, contact_types=(GEOM_SPHERE,),
      contact_geoms=quad.plan_contact_geoms, residual=spec,
      naux=spec["naux"], record_states=False, cost_terms=cost_terms,
      _profile=True)
  args = chip_smoke.make_quadruped_inputs(
      quad, spec, cost_terms, K, np.random.default_rng(0), "cuda")
  ms = chip_smoke.time_cuda(lambda: kern(*args), 5)
  lib = _build.load("lane_rollout.cu", kern.build_defines())
  buf = (ctypes.c_ulonglong * 20)()

  def read():
    err = lib.lane_profile(buf)
    if err != 0:
      raise RuntimeError(f"lane_profile failed: CUDA error {err}")
    return list(buf)

  before = read()
  kern(*args)
  torch.cuda.synchronize()
  cycles = [a - b for a, b in zip(read(), before)]
  total = sum(cycles)
  print(json.dumps(dict(K=K, H=HORIZON, instrumented_ms=ms,
                        total_cycles=total, cycles_per_step=total / HORIZON,
                        card=card)), flush=True)
  for slot, name in SECTIONS.items():
    print(json.dumps(dict(section=name, cycles=cycles[slot],
                          share=round(cycles[slot] / total, 4),
                          cycles_per_step=round(cycles[slot] / HORIZON))),
          flush=True)
  print(card)
  return 0


if __name__ == "__main__":
  sys.exit(main())
