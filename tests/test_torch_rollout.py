"""Port vs JAX: trajectory rollouts on the pipeline physics (rollout.py).

`rollout` and `noisy_rollout` of one spline policy, and the batched form
the sampling planners use (`make_batched_returns`: vmapped over
candidates, every SPD solve on the batched Cholesky kernel's route, the
returns from the fused scoring kernel's route — both their plain versions
here), on Swimmer (Euler, fluid, joint limits) and Cartpole (RK4), 8 steps,
3 candidates. The JAX side is ONE jitted function per task (clean and noisy
rollouts, vmapped, and the OU noise its keys give, which the port is
handed). Tolerances: the JAX suite's kernel-vs-pipeline bars — 2e-4 on
states, 5e-4 on residual rows, 1e-4 relative on returns and costs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import rollout as jrollout
from mujoco_mpc_tpu import spline as jspline
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import rollout as trollout
from mujoco_mpc_tpu_torch import spline as tspline
from mujoco_mpc_tpu_torch.ops import cholesky as tcholesky
from mujoco_mpc_tpu_torch.ops import scoring as tscoring
from tests.torch_port_helpers import once_a_session, to_np, tt

H, K, P = 8, 3, 4
DT = 0.03
XFRC_STD, XFRC_RATE = 0.2, 0.1
TOL_STATES, TOL_ROWS, TOL_RETURN_REL = 2e-4, 5e-4, 1e-4


TRAJECTORY = ("states", "actions", "times", "residuals", "costs",
              "total_return", "failure")


def _jax_case(name):
  """The JAX side of `case` as numpy arrays: the start state, the
  candidates, the clean and noisy trajectories (`clean_<field>`,
  `noisy_<field>`) and the OU noise the keys gave."""
  jt = jregistry.get_task(name)
  m = jt.plan_model
  rng = np.random.default_rng(len(name))
  d0 = jt.make_data()
  qpos = np.asarray(d0.qpos) + 0.2 * rng.standard_normal(m.nq).astype(
      np.float32)
  qvel = 0.3 * rng.standard_normal(m.nv).astype(np.float32)
  jd0 = d0.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   time=jnp.asarray(0.25, jnp.float32))
  lo = np.asarray(m.actuator_ctrlrange[:, 0])
  hi = np.asarray(m.actuator_ctrlrange[:, 1])
  # some nodes beyond the control range: the rollout clips
  values = rng.uniform(1.3 * lo, 1.3 * hi, (K, P, m.nu)).astype(np.float32)
  keys = jax.random.split(jax.random.PRNGKey(7), K)
  rf = lambda mm, dd: jt.residual(mm, dd, jt.residual_params)

  def policy(v):
    pol = jspline.SplinePolicy(t0=jnp.float32(0.25), dt=jnp.float32(DT),
                               values=v, interp=0)
    return lambda state, time: jspline.sample(pol, time)

  @jax.jit
  def run(vals, keys):
    clean = jax.vmap(lambda v: jrollout.rollout(
        m, rf, jt.cost_spec.cost, policy(v), jd0, H))(vals)
    noisy = jax.vmap(lambda v, k: jrollout.noisy_rollout(
        m, rf, jt.cost_spec.cost, policy(v), jd0, H, k,
        jnp.float32(XFRC_STD), jnp.float32(XFRC_RATE)))(vals, keys)
    noise = jax.vmap(lambda key: jax.vmap(
        lambda k: jax.random.normal(k, (m.nbody, 6)))(
            jax.random.split(key, H - 1)))(keys)
    return clean, noisy, noise

  clean, noisy, noise = run(jnp.asarray(values), keys)
  out = dict(qpos=qpos, qvel=qvel, values=values, noise=np.asarray(noise))
  for prefix, traj in (("clean", clean), ("noisy", noisy)):
    out.update({f"{prefix}_{f}": np.asarray(getattr(traj, f))
                for f in TRAJECTORY})
  return out


@pytest.fixture(scope="module", params=["Swimmer", "Cartpole"])
def case(request, tmp_path_factory):
  """One task's JAX rollouts, once a test session (`once_a_session`: the
  file's ten tests spread over the workers), and the port's task and start
  state."""
  name = request.param
  j = once_a_session(tmp_path_factory, f"rollout_case_{name}",
                     lambda: _jax_case(name))
  pt = tregistry_get(name)
  pd0 = pt.make_data().replace(qpos=tt(j["qpos"]), qvel=tt(j["qvel"]),
                               time=torch.tensor(0.25))
  traj = {prefix: types.SimpleNamespace(
      **{f: j[f"{prefix}_{f}"] for f in TRAJECTORY})
      for prefix in ("clean", "noisy")}
  return dict(name=name, pt=pt, pd0=pd0, values=j["values"],
              clean=traj["clean"], noisy=traj["noisy"], noise=j["noise"])


def tregistry_get(name):
  from mujoco_mpc_tpu_torch.tasks import registry
  return registry.get_task(name, device="cpu")


def _policy(v):
  pol = tspline.SplinePolicy(t0=torch.tensor(0.25), dt=torch.tensor(DT),
                             values=tt(v), interp=0)
  return lambda state, time: tspline.sample(pol, time)


def _check_trajectory(got, want, c):
  np.testing.assert_allclose(to_np(got.states), np.asarray(want.states)[c],
                             atol=TOL_STATES, rtol=TOL_STATES)
  np.testing.assert_allclose(to_np(got.actions),
                             np.asarray(want.actions)[c], atol=1e-6)
  np.testing.assert_allclose(to_np(got.times), np.asarray(want.times)[c],
                             atol=1e-6)
  np.testing.assert_allclose(to_np(got.residuals),
                             np.asarray(want.residuals)[c], atol=TOL_ROWS,
                             rtol=TOL_ROWS)
  np.testing.assert_allclose(to_np(got.costs), np.asarray(want.costs)[c],
                             rtol=TOL_RETURN_REL)
  np.testing.assert_allclose(float(got.total_return),
                             float(np.asarray(want.total_return)[c]),
                             rtol=TOL_RETURN_REL)
  assert bool(got.failure) == bool(np.asarray(want.failure)[c])


def test_rollout_matches_jax(case):
  pt = case["pt"]
  rf = lambda mm, dd: pt.residual(mm, dd, pt.residual_params)
  for c in range(K):
    got = trollout.rollout(pt.plan_model, rf, pt.cost_spec.cost,
                           _policy(case["values"][c]), case["pd0"], H)
    assert got.states.shape == (H, pt.plan_model.nq + pt.plan_model.nv)
    _check_trajectory(got, case["clean"], c)


def test_noisy_rollout_matches_jax_with_the_same_noise(case):
  pt = case["pt"]
  rf = lambda mm, dd: pt.residual(mm, dd, pt.residual_params)
  for c in range(K):
    got = trollout.noisy_rollout(
        pt.plan_model, rf, pt.cost_spec.cost, _policy(case["values"][c]),
        case["pd0"], H, None, XFRC_STD, XFRC_RATE,
        noise=tt(case["noise"][c]))
    _check_trajectory(got, case["noisy"], c)
  # the noise moved the trajectories
  assert np.abs(np.asarray(case["noisy"].states) -
                np.asarray(case["clean"].states)).max() > 1e-4


@pytest.mark.parametrize("noisy", [False, True])
def test_batched_returns_match_jax(case, noisy):
  """The planners' batched form: returns from one (plain) scoring call,
  every solve on the batched Cholesky route (its plain version counts no
  launch)."""
  pt = case["pt"]
  want = case["noisy"] if noisy else case["clean"]
  kw = dict(xfrc_std=XFRC_STD, xfrc_rate=XFRC_RATE) if noisy else {}
  fn = trollout.make_batched_returns(
      pt.plan_model, lambda mm, dd: pt.residual(mm, dd, pt.residual_params),
      pt.cost_spec, H, 0, **kw)
  assert fn.routes == dict(rollouts="pipeline", spd_solve="kernel",
                           scoring="kernel")
  launches = (tcholesky.launch_count, tscoring.launch_count)
  returns, failure, residuals = fn(
      tt(case["values"]), torch.tensor(0.25), torch.tensor(DT), case["pd0"],
      noise=tt(case["noise"]) if noisy else None)
  assert (tcholesky.launch_count, tscoring.launch_count) == launches
  np.testing.assert_allclose(to_np(returns), np.asarray(want.total_return),
                             rtol=TOL_RETURN_REL)
  np.testing.assert_allclose(to_np(residuals), np.asarray(want.residuals),
                             atol=TOL_ROWS, rtol=TOL_ROWS)
  np.testing.assert_array_equal(to_np(failure), np.asarray(want.failure))
