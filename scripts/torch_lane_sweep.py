"""Time variants of the lane rollout CUDA kernel on the card.

    python3 scripts/torch_lane_sweep.py            # needs one NVIDIA GPU

Builds several specialisations of ops/csrc/lane_rollout.cu for Quadruped
Flat (cost-sum mode, horizon 36, 3 spline points, feet-only contacts) side
by side and times each with CUDA events on the planner's own kind of
inputs (home pose, nominal + 0.04 exploration noise):

  * threads per block 32 / 64 / 128 at K=4096;
  * the solver schedule cut down (Newton iterations 0 / 1 / 4, line-search
    iterations 0 / 4) and the contacts taken out — by differences, a rough
    breakdown of where the step's time goes;
  * K from 1024 to 16384 with the default build.

Prints one JSON line per variant (milliseconds per launch, registers and
spill bytes from `ptxas -v`) and the card's name and power limit. A
measuring tool: nothing in the package depends on it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import chip_smoke  # noqa: E402  (input maker and timer)
from mujoco_mpc_tpu_torch.ops import _build, step_lane  # noqa: E402
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402

HORIZON, P = 36, 3


def main():
  if not torch.cuda.is_available():
    print("torch_lane_sweep: no CUDA device available", file=sys.stderr)
    return 1
  card = chip_smoke.card_line()
  quad = registry.get_task("Quadruped Flat", device="cuda")
  spec = quad.lane_residual_spec()
  cost_terms = tuple(zip(quad.cost_spec.norm_types, quad.cost_spec.dims))

  def make(block=32, newton=None, ls=None, contacts=True):
    return step_lane.build_rollout_kernel(
        quad.plan_model, HORIZON, P, contact_types=(GEOM_SPHERE,),
        contact_geoms=quad.plan_contact_geoms if contacts else frozenset(),
        solver_iters=newton, solver_ls_iters=ls, residual=spec,
        naux=spec["naux"], record_states=False, cost_terms=cost_terms,
        _block=block)

  variants = {
      "block32": make(32), "block64": make(64), "block128": make(128),
      "newton0": make(newton=0, ls=0), "newton1_ls0": make(newton=1, ls=0),
      "newton1_ls4": make(newton=1, ls=4), "newton4_ls0": make(newton=4, ls=0),
      "no_contacts": make(contacts=False),
      "no_contacts_newton0": make(contacts=False, newton=0, ls=0),
  }
  t0 = time.perf_counter()
  procs = {n: _build.start_build("lane_rollout.cu", k.build_defines())
           for n, k in variants.items()}
  for n, (path, proc) in procs.items():
    _build.finish_build(proc)
  print(json.dumps(dict(phase="build", variants=len(variants),
                        seconds=round(time.perf_counter() - t0, 1))),
        flush=True)

  rng = np.random.default_rng(0)
  inputs = {k: chip_smoke.make_quadruped_inputs(quad, spec, cost_terms, k,
                                                rng, "cuda")
            for k in (1024, 2048, 4096, 8192, 16384)}
  for name, kern in variants.items():
    args = inputs[4096]
    ms = chip_smoke.time_cuda(lambda: kern(*args), 10)
    print(json.dumps(dict(variant=name, K=4096, H=HORIZON, ms=ms,
                          ptxas=_build.BUILD_LOG[procs[name][0]]["ptxas"],
                          card=card)), flush=True)
  for name in ("block32", "block128"):
    kern = variants[name]
    for k, args in inputs.items():
      ms = chip_smoke.time_cuda(lambda: kern(*args), 5)
      print(json.dumps(dict(variant=name, K=k, H=HORIZON, ms=ms,
                            rollouts_per_s=k / (ms * 1e-3), card=card)),
            flush=True)
  print(card)
  return 0


if __name__ == "__main__":
  sys.exit(main())
