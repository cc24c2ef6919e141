"""Reading: where the robust planner's noisy re-rolls blow up on Swimmer, in
the JAX package and in the port, from the same inputs.

The robust planner re-rolls its top candidates under Ornstein-Uhlenbeck
body-wrench noise (`noisy_rollout`). On Swimmer at the task's own
configuration (201 steps of 0.01 s, 10 spline nodes) and the JAX defaults
(std 0.2, rate 0.1) most re-rolls pass 1e7 in qpos or qvel and are
poisoned. This script rolls 16 re-rolls of 16 seeded candidates (numpy,
exploration 0.05 as the task's) in both packages on the CPU, with the OU
standard normals the JAX keys give handed to the port, at std 0.2 and at
std 0.05, and prints one JSON line per std:

  * `poisoned_jax`, `poisoned_port`: re-rolls marked failed;
  * `first_bad_jax`, `first_bad_port`: per re-roll, the first recorded state
    that is not finite or exceeds 1e7 (-1: none);
  * `first_step_over_tol`: per re-roll, the first step whose state differs
    between the packages by more than 2e-4 relative (-1: none);
  * `max_rel_diff_survivors`: the largest such difference over the whole
    horizon of the re-rolls that survive in both.

Exits 1 if the two packages poison different re-rolls or blow up at
different steps. Run from the repo root (about 2.5 minutes):

  JAX_PLATFORMS=cpu python -m tests.robust_divergence_reading
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_mpc_tpu import rollout as jrollout
from mujoco_mpc_tpu import spline as jspline
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import rollout as trollout
from mujoco_mpc_tpu_torch import spline as tspline
from mujoco_mpc_tpu_torch.tasks import registry as tregistry

H, B, P = 201, 16, 10
EXPLORATION = 0.05
XFRC_RATE = 0.1
STDS = (0.2, 0.05)
TOL = 2e-4
SEED = 0


def first_bad(states):
  """(B, T, n) -> per re-roll the first state that is not finite or > 1e7."""
  with np.errstate(invalid="ignore"):
    bad = ~np.isfinite(states).all(-1) | (np.abs(states).max(-1) > 1e7)
  return [int(np.argmax(b)) if b.any() else -1 for b in bad]


def reading(std, jt, pt, values, keys):
  m = jt.plan_model
  dt = (H - 1) * float(m.opt.timestep) / P
  rf = lambda mm, dd: jt.residual(mm, dd, jt.residual_params)
  jd0 = jt.make_data()

  def policy(v):
    pol = jspline.SplinePolicy(t0=jnp.float32(0.0), dt=jnp.float32(dt),
                               values=v, interp=0)
    return lambda state, time: jspline.sample(pol, time)

  @jax.jit
  def run(vals, keys):
    traj = jax.vmap(lambda v, k: jrollout.noisy_rollout(
        m, rf, jt.cost_spec.cost, policy(v), jd0, H, k, jnp.float32(std),
        jnp.float32(XFRC_RATE)))(vals, keys)
    noise = jax.vmap(lambda key: jax.vmap(
        lambda k: jax.random.normal(k, (m.nbody, 6)))(
            jax.random.split(key, H - 1)))(keys)
    return traj, noise

  traj, noise = run(jnp.asarray(values), keys)
  js = np.asarray(traj.states)
  prf = lambda mm, dd: pt.residual(mm, dd, pt.residual_params)
  ps, pfail = [], []
  for b in range(B):
    pol = tspline.SplinePolicy(t0=torch.tensor(0.0), dt=torch.tensor(dt),
                               values=torch.as_tensor(values[b]), interp=0)
    got = trollout.noisy_rollout(
        pt.plan_model, prf, pt.cost_spec.cost,
        lambda state, time, pol=pol: tspline.sample(pol, time),
        pt.make_data(), H, None, std, XFRC_RATE,
        noise=torch.as_tensor(np.asarray(noise)[b]))
    ps.append(got.states.numpy())
    pfail.append(bool(got.failure))
  ps = np.stack(ps)
  jfail = np.asarray(traj.failure).astype(bool).tolist()
  with np.errstate(invalid="ignore", over="ignore"):
    rel = (np.abs(ps - js) / (1.0 + np.abs(js))).max(-1)      # (B, T)
  over = [int(np.argmax(~(r <= TOL))) if (~(r <= TOL)).any() else -1
          for r in rel]
  survivors = [b for b in range(B) if not jfail[b] and not pfail[b]]
  return dict(
      std=std, rate=XFRC_RATE, H=H, rerolls=B, seed=SEED,
      poisoned_jax=int(sum(jfail)), poisoned_port=int(sum(pfail)),
      same_rerolls_poisoned=jfail == pfail,
      first_bad_jax=first_bad(js), first_bad_port=first_bad(ps),
      first_step_over_tol=over, tol_rel=TOL,
      max_rel_diff_survivors=(float(rel[survivors].max()) if survivors
                              else None))


def main():
  torch.set_num_threads(2)
  jt = jregistry.get_task("Swimmer")
  pt = tregistry.get_task("Swimmer", device="cpu")
  m = jt.plan_model
  lo = np.asarray(m.actuator_ctrlrange[:, 0])
  hi = np.asarray(m.actuator_ctrlrange[:, 1])
  rng = np.random.default_rng(SEED)
  values = np.clip(EXPLORATION * 0.5 * (hi - lo) *
                   rng.standard_normal((B, P, m.nu)), lo, hi)
  values = values.astype(np.float32)
  keys = jax.random.split(jax.random.PRNGKey(SEED), B)
  ok = True
  for std in STDS:
    out = reading(std, jt, pt, values, keys)
    print(json.dumps(out), flush=True)
    ok &= out["same_rerolls_poisoned"] and \
        out["first_bad_jax"] == out["first_bad_port"]
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
