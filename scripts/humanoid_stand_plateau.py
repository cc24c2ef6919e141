"""Does the JAX package's lane planner plateau on Humanoid Stand as the
port's does? Both packages' own predictive-sampling optimizers on the CPU,
from the same state, with the same injected noise.

    JAX_PLATFORMS=cpu python scripts/humanoid_stand_plateau.py \
        [--k 16] [--iterations 4] [--seed 0]

What is seen on the card (`chip_smoke.py` humanoid_stand_path, K=512,
H=25): after the warm-up iteration the nominal stays the argmin of the
candidates. Here both planners run predictive sampling on Humanoid Stand at
the path's horizon (25), spline points (2) and exploration (0.08), planning
from the task's home state every iteration (as the path does), K small:
  * the port: `ops/sampling_lane.make_lane_optimize_fn` on CPU tensors (the
    rollout kernel's plain version), fed the pre-drawn noise;
  * the JAX package: its own `ops/sampling_lane.make_lane_optimize_fn` (its
    spline resample, `planners/sampling.add_noise`, the scoring of
    `make_lane_returns_fn`, the argmin and the policy update), with two
    stand-ins made here: `jax.random.normal` returns the pre-drawn noise
    inside `add_noise`, and the rollout kernel is its own step body
    (`build_rollout_kernel(...).step_array`) looped over the horizon
    eagerly, the residual rows reduced per term by `lane_term_cost` as the
    kernel's cost-sum mode does (the Pallas kernel in interpret mode, or the
    humanoid step compiled for the CPU, takes too long or too much memory).
Each iteration draws one set of standard normals (numpy, from --seed) that
both packages add to their own nominal. Prints one JSON line per iteration:
each package's nominal and best returns, winner, whether the nominal won,
how far the two packages' returns are apart, and how far their new
policies are apart. A reading, not a test: the JAX step runs eagerly
(~15-20 s a step of the humanoid, so ~7 minutes an iteration).
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from mujoco_mpc_tpu.ops import sampling_lane as jsampling_lane  # noqa: E402
from mujoco_mpc_tpu.ops import step_lane as jstep  # noqa: E402
from mujoco_mpc_tpu.planners import sampling as jsampling  # noqa: E402
from mujoco_mpc_tpu.tasks import registry as jregistry  # noqa: E402
from mujoco_mpc_tpu_torch.ops import sampling_lane  # noqa: E402
from mujoco_mpc_tpu_torch.planners import sampling  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry as tregistry  # noqa: E402

HORIZON, EXPLORATION = 25, 0.08     # humanoid_stand_path's configuration


def eager_rollout_kernel(m, horizon, num_nodes, **kw):
  """The JAX kernel's cost-sum mode, stepped eagerly: fn(qpos0, qvel0,
  values (P*nu, K), aux) -> (per-term sums (nterm, K), final state)."""
  built = jstep.build_rollout_kernel(m, horizon, num_nodes, **kw)
  naux, nu = kw["naux"], m.nu
  terms = kw["cost_terms"]
  node_of = [min(int(t * num_nodes / max(horizon - 1, 1)), num_nodes - 1)
             for t in range(horizon)]

  def kernel(qpos, qvel, values, aux):
    sums = [0.0] * len(terms)
    for t in range(horizon):
      node = node_of[t]
      qpos, qvel, res = built.step_array(
          qpos, qvel, values[node * nu:(node + 1) * nu], t, aux)
      off = 0
      for n, (ntype, dim) in enumerate(terms):
        sums[n] = sums[n] + jstep.lane_term_cost(
            [res[off + i] for i in range(dim)], int(ntype),
            aux[naux + 2 * n], aux[naux + 2 * n + 1])
        off += dim
    return jnp.stack(sums), jnp.concatenate([qpos, qvel])
  return kernel


@contextlib.contextmanager
def injected_normal(noise):
  """jax.random.normal returns `noise` (its shape asserted) meanwhile."""
  normal = jax.random.normal

  def fixed(key, shape, dtype=jnp.float32):
    assert tuple(shape) == noise.shape, (shape, noise.shape)
    return jnp.asarray(noise, dtype)
  jax.random.normal = fixed
  try:
    yield
  finally:
    jax.random.normal = normal


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--k", type=int, default=16)
  parser.add_argument("--iterations", type=int, default=4)
  parser.add_argument("--seed", type=int, default=0)
  a = parser.parse_args()
  jax.config.update("jax_platforms", "cpu")
  jt = jregistry.get_task("Humanoid Stand")
  pt = tregistry.get_task("Humanoid Stand", device="cpu")
  cfg = dataclasses.replace(sampling.make_config(pt), num_trajectory=a.k,
                            horizon=HORIZON, exploration=(EXPLORATION, 0.0))
  jcfg = jsampling.make_config(jt).replace(
      num_trajectory=a.k, horizon=HORIZON,
      exploration=jnp.asarray([EXPLORATION, 0.0], jnp.float32))
  p, nu = cfg.num_spline_points, pt.plan_model.nu
  assert (jcfg.num_spline_points, jcfg.interp) == (p, cfg.interp)
  # the JAX optimizer with its kernel stepped eagerly
  jsampling_lane.step_lane = types.SimpleNamespace(
      supports=jstep.supports, build_rollout_kernel=eager_rollout_kernel)
  optimize_jax = jsampling_lane.make_lane_optimize_fn(jt, jcfg,
                                                      interpret=True)
  policy_jax = jsampling.initial_policy(jt.plan_model, jcfg)
  optimize = sampling_lane.make_lane_optimize_fn(pt, cfg)
  policy = sampling.initial_policy(pt.plan_model, cfg, device="cpu")
  d0, jd0 = pt.make_data(), jt.make_data()
  rng = np.random.default_rng(a.seed)
  print(json.dumps(dict(task="Humanoid Stand", K=a.k, H=HORIZON, P=p,
                        exploration=EXPLORATION, seed=a.seed)), flush=True)
  for it in range(a.iterations):
    noise = rng.standard_normal((a.k - 1, p, nu)).astype(np.float32)
    u = np.ones(a.k - 1, np.float32)          # second std unused (0)
    t0 = time.perf_counter()
    policy, info = optimize(None, d0, policy, noise=torch.as_tensor(noise),
                            u=torch.as_tensor(u))
    port_s = time.perf_counter() - t0
    r_port = info["returns"].numpy()
    t0 = time.perf_counter()
    with jax.disable_jit(), injected_normal(noise):
      policy_jax, jinfo = optimize_jax(jax.random.PRNGKey(it), jd0,
                                       policy_jax)
    jax_s = time.perf_counter() - t0
    r_jax = np.asarray(jinfo["returns"])
    w_port, w_jax = int(np.argmin(r_port)), int(jinfo["winner"])
    rel = np.abs(r_port - r_jax) / np.maximum(1.0, np.abs(r_jax))
    print(json.dumps(dict(
        iteration=it,
        port=dict(nominal_return=float(r_port[0]),
                  best_return=float(r_port.min()), winner=w_port,
                  nominal_wins=w_port == 0, seconds=port_s),
        jax=dict(nominal_return=float(r_jax[0]),
                 best_return=float(r_jax.min()), winner=w_jax,
                 nominal_wins=w_jax == 0, seconds=jax_s),
        max_rel_return_diff=float(rel.max()),
        share_within_1e_4=float((rel <= 1e-4).mean()),
        policy_max_abs_diff=float(np.abs(
            policy.values.numpy() - np.asarray(policy_jax.values)).max()))),
        flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
