"""The port's Gradient planner against the JAX package's.

The value and gradient of the rollout's total return with respect to the
spline values (the port's loop of one step's vector-Jacobian product,
planners/gradient.py ValueAndGrad) against `jax.value_and_grad` of the
JAX rollout: Cartpole (RK4, joint limits) at H=11 and Swimmer (Euler,
fluid) at H=6, from moving states. Bars: the direction's cosine >= 0.9999,
the norm within 1e-3 relative, the value within 1e-4 relative. Then one
whole `optimize` on Cartpole against the JAX planner's from the same
policy: nominal and best return, gradient norm, chosen step and the new
policy. The JAX side is jitted (its eager value and gradient take minutes
at these sizes).

Both use 3 spline nodes. With the tasks' 10 the nodes fall exactly on step
times, where the zero-order hold's node index is decided by the last bit
of (t - t0) / dt, which the jitted JAX side rounds the other way at some
steps: the returns then differ by ~1e-4 and their gradients by far more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import rollout as JR
from mujoco_mpc_tpu import spline as JS
from mujoco_mpc_tpu.planners import gradient as JG
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch import rollout as TR
from mujoco_mpc_tpu_torch import spline as TS
from mujoco_mpc_tpu_torch.planners import base as tbase
from mujoco_mpc_tpu_torch.planners import gradient as TG
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import once_a_session, to_np, tt

CASES = {"Cartpole": 11, "Swimmer": 6}
NODES = 3


def _start(name, pt, seed):
  """(qpos, qvel, spline values) away from rest: a moving state and a
  perturbed policy, so that the gradient is far from zero."""
  rng = np.random.default_rng(seed)
  m = pt.plan_model
  qpos = np.asarray(pt.make_data().qpos, np.float32) + \
      0.2 * rng.standard_normal(m.nq).astype(np.float32)
  qvel = 0.5 * rng.standard_normal(m.nv).astype(np.float32)
  lo, hi = to_np(m.actuator_ctrlrange).T
  values = rng.uniform(0.6 * lo, 0.6 * hi, (NODES, m.nu))
  return qpos, qvel, values.astype(np.float32)


def _jax_setup(name, horizon, qpos, qvel):
  jt = jregistry.get_task(name)
  cfg = JG.make_config(jt).replace(horizon=horizon,
                                   num_spline_points=NODES)
  d0 = jt.make_data().replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
  policy = JG.GradientPlanner(jt, cfg).policy
  return jt, cfg, d0, policy


def _jax_value_and_grad(name, horizon, qpos, qvel, values):
  """The JAX rollout's total return and its gradient with respect to the
  resampled spline values, with that spline's t0, dt and values."""
  jt, jcfg, jd0, jpol = _jax_setup(name, horizon, qpos, qvel)
  jm = jt.plan_model
  jpol = JS.resample(jpol.replace(values=jnp.asarray(values)), jd0.time,
                     (horizon - 1) * jm.opt.timestep)

  def total(v):
    pol = jpol.replace(values=v)
    return JR.rollout(jm, lambda m, d: jt.residual(m, d, jt.residual_params),
                      jt.cost_spec.cost, lambda s, t: JS.sample(pol, t), jd0,
                      horizon).total_return

  jval, jgrad = jax.jit(jax.value_and_grad(total))(jpol.values)
  return dict(val=np.asarray(jval), grad=np.asarray(jgrad),
              t0=np.asarray(jpol.t0), dt=np.asarray(jpol.dt),
              values=np.asarray(jpol.values), interp=np.asarray(jcfg.interp),
              horizon=np.asarray(jcfg.horizon),
              nodes=np.asarray(jcfg.num_spline_points))


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_and_gradient_match_jax(name, tmp_path_factory):
  horizon = CASES[name]
  pt = tregistry.get_task(name, device="cpu")
  qpos, qvel, values = _start(name, pt, seed=len(name))
  want = once_a_session(
      tmp_path_factory, f"gradient_value_and_grad_{name}",
      lambda: _jax_value_and_grad(name, horizon, qpos, qvel, values))
  jval, jgrad = want["val"], want["grad"]

  pm = pt.plan_model
  pd0 = convert.data_from_numpy(pm, qpos=qpos, qvel=qvel)
  cfg = TG.make_config(pt).replace(horizon=horizon,
                                   num_spline_points=NODES)
  assert (cfg.horizon, cfg.num_spline_points, cfg.interp) == (
      int(want["horizon"]), int(want["nodes"]), int(want["interp"]))
  ppol = convert.policy_from_numpy(want["t0"], want["dt"], want["values"],
                                   device="cpu")
  fn = TG.ValueAndGrad(pm, pt.residual, horizon, cfg.interp)
  val, grad, failure = fn(ppol.values, ppol.t0, ppol.dt, pd0,
                          pt.residual_params, pt.cost_spec)
  assert not bool(failure)
  jg, g = np.asarray(jgrad).ravel(), to_np(grad).ravel()
  cosine = float(g @ jg / (np.linalg.norm(g) * np.linalg.norm(jg)))
  assert cosine >= 0.9999, cosine
  np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(jg),
                             rtol=1e-3)
  np.testing.assert_allclose(float(val), float(jval), rtol=1e-4)
  assert np.linalg.norm(jg) > 1e-3                    # not trivial

  # the loop against autograd through the port's own whole rollout
  v = ppol.values.clone().requires_grad_(True)
  traj = TR.rollout(pm, lambda m, d: pt.residual(m, d, pt.residual_params),
                    pt.cost_spec.cost,
                    lambda s, t: TS.sample(ppol.replace(values=v), t), pd0,
                    horizon)
  traj.total_return.backward()
  np.testing.assert_allclose(float(traj.total_return.detach()), float(val),
                             rtol=1e-6)
  np.testing.assert_allclose(to_np(v.grad), to_np(grad), atol=1e-6,
                             rtol=1e-4)


def _jax_one_iteration(name, horizon, qpos, qvel, values):
  """One JAX Gradient optimize from the spline `values`: the new policy's
  values, the info the test reads, and the start policy's t0 and dt."""
  jt, jcfg, jd0, jpol = _jax_setup(name, horizon, qpos, qvel)
  jpol = jpol.replace(values=jnp.asarray(values))
  opt = JG.make_optimize_fn(
      jt.plan_model, lambda m, d: jt.residual(m, d, jt.residual_params),
      jt.cost_spec.cost, jcfg, residual_fn_with_params=jt.residual)
  jnew, jinfo = jax.jit(opt)(None, jd0, jpol, jt.residual_params,
                             jt.cost_spec)
  out = {key: np.asarray(jinfo[key]) for key in (
      "nominal_return", "best_return", "grad_norm", "step", "improved")}
  out.update(new_values=np.asarray(jnew.values), t0=np.asarray(jpol.t0),
             dt=np.asarray(jpol.dt))
  return out


def test_one_iteration_matches_jax_on_cartpole(tmp_path_factory):
  name, horizon = "Cartpole", CASES["Cartpole"]
  pt = tregistry.get_task(name, device="cpu")
  qpos, qvel, values = _start(name, pt, seed=21)
  jinfo = once_a_session(
      tmp_path_factory, "gradient_one_iteration_cartpole",
      lambda: _jax_one_iteration(name, horizon, qpos, qvel, values))

  planner = tbase.make_planner(pt, "Gradient", device="cpu")
  assert isinstance(planner, TG.GradientPlanner)
  planner = TG.GradientPlanner(
      pt, planner.config.replace(horizon=horizon, num_spline_points=NODES),
      device="cpu")
  assert planner.routes == dict(value_and_grad="vjp_eager",
                                line_search="pipeline", spd_solve="kernel",
                                scoring="kernel")
  planner.policy = convert.policy_from_numpy(jinfo["t0"], jinfo["dt"],
                                             values, device="cpu")
  pd0 = convert.data_from_numpy(pt.plan_model, qpos=qpos, qvel=qvel)
  info = planner.optimize(None, pd0)
  for key in ("nominal_return", "best_return", "grad_norm", "step"):
    np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                               rtol=1e-3, err_msg=key)
  assert bool(info["improved"]) == bool(jinfo["improved"]) is True
  np.testing.assert_allclose(to_np(planner.policy.values),
                             jinfo["new_values"], atol=1e-4)
  # 8 candidates: clipped, log-scaled steps along one direction, their
  # returns those of the port's own rollouts
  cands, returns = info["candidates"], info["returns"]
  assert cands.shape == (8, NODES, 1) and returns.shape == (8,)
  best = int(torch.argmin(returns))
  np.testing.assert_allclose(float(returns[best]), float(info["best_return"]))
  m = pt.plan_model
  for c in (0, best, 7):
    pol = planner.policy.replace(values=cands[c])
    want = TR.rollout(m, lambda mm, d: pt.residual(mm, d, pt.residual_params),
                      pt.cost_spec.cost, lambda s, t: TS.sample(pol, t), pd0,
                      horizon).total_return
    np.testing.assert_allclose(float(returns[c]), float(want), rtol=1e-5)
  steps = to_np(cands - cands[-1:])                   # along one direction
  norms = np.linalg.norm(steps.reshape(8, -1), axis=1)
  assert np.all(np.diff(norms[:-1]) < 0)
  action = planner.action(0.01)
  assert action.shape == (1,) and bool(torch.isfinite(action).all())


def test_step_loop_matches_the_vmapped_rollouts():
  """The Gradient line search's batched rollouts as one function of one
  batched step (rollout.StepLoop: what a CUDA graph replays on the card,
  run eagerly here) against the vmapped whole-horizon rollouts of
  rollout.make_batched_returns."""
  pt = tregistry.get_task("Swimmer", device="cpu")
  m, horizon = pt.plan_model, 6
  qpos, qvel, values = _start("Swimmer", pt, seed=4)
  d0 = convert.data_from_numpy(m, qpos=qpos, qvel=qvel)
  rng = np.random.default_rng(5)
  cands = tt(values[None] + 0.3 * rng.standard_normal((3,) + values.shape))
  t0, dt = torch.tensor(0.0), torch.tensor(0.02)
  loop = TR.StepLoop(m.replace(solve_route="kernel"), pt.residual, horizon,
                     0)
  plain = TR.make_batched_returns(
      m, lambda mm, d: pt.residual(mm, d, pt.residual_params), pt.cost_spec,
      horizon, 0)
  got = loop(cands, t0, dt, d0, pt.residual_params)
  _, fails, residuals = plain(cands, t0, dt, d0)
  again = loop(cands, t0, dt, d0, pt.residual_params)
  for g, w, a in zip(got, (residuals, fails), again):
    np.testing.assert_allclose(to_np(g), to_np(w), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(to_np(a), to_np(g))
