"""Port vs JAX: the sampling-family planners — cross-entropy,
sample-gradient, robust, iLQS and the pipeline predictive-sampling planner.

Parity tests hand both packages the same numbers: the standard normals and
uniforms each JAX planner draws from its key are recomputed from that key
and given to the port; where the test is about the update logic (elite
refit, fitness-shaped gradient, top-N selection, iLQS's switch and spline
fit) a fixed `returns_fn` gives both packages the same returns (no ties),
and iLQS runs against stand-in sampler / iLQG objects. Policies, elite mean
and variance, the filtered gradient and the winners agree to 1e-5; returns
that come from rollouts (the pipeline sampling planner, robust's noisy
re-rolls; JAX jitted at 5 steps on Swimmer) to 1e-4 relative.

Behaviour tests run the port's own noise on Cartpole (lane or pipeline
route, plain versions of the kernels): the cost goes down over 3
iterations.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import spline as jspline
from mujoco_mpc_tpu.planners import base as jbase
from mujoco_mpc_tpu.planners import cross_entropy as jce
from mujoco_mpc_tpu.planners import ilqs as jilqs
from mujoco_mpc_tpu.planners import robust as jrobust
from mujoco_mpc_tpu.planners import sample_gradient as jsg
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import spline as tspline
from mujoco_mpc_tpu_torch.planners import base as tbase
from mujoco_mpc_tpu_torch.planners import cross_entropy as tce
from mujoco_mpc_tpu_torch.planners import ilqs as tilqs
from mujoco_mpc_tpu_torch.planners import robust as trobust
from mujoco_mpc_tpu_torch.planners import sample_gradient as tsg
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

TOL = 1e-5
TOL_RETURN_REL = 1e-4
P = 4


@pytest.fixture(scope="module")
def swimmer():
  jt = jregistry.get_task("Swimmer")
  pt = tregistry.get_task("Swimmer", device="cpu")
  rng = np.random.default_rng(0)
  qpos = to_np(pt.make_data().qpos) + 0.1 * rng.standard_normal(
      pt.plan_model.nq).astype(np.float32)
  jd0 = jt.make_data().replace(qpos=jnp.asarray(qpos),
                               time=jnp.asarray(0.12, jnp.float32))
  pd0 = pt.make_data().replace(qpos=tt(qpos), time=torch.tensor(0.12))
  return dict(jt=jt, pt=pt, jd0=jd0, pd0=pd0, nu=pt.plan_model.nu)


def _values(rng, nu, lo=-0.8, hi=0.8):
  return rng.uniform(lo, hi, (P, nu)).astype(np.float32)


def _fixed_returns(sizes, seed):
  """returns_fn for both packages: fixed, tie-free returns by batch size."""
  rng = np.random.default_rng(seed)
  table = {k: (rng.permutation(k) + 0.1 * rng.random(k)).astype(np.float32)
           for k in sizes}

  def jfn(cands, d0, params=None, cs=None):
    return jnp.asarray(table[cands.shape[0]])

  def tfn(cands, d0, params=None, cs=None):
    return tt(table[cands.shape[0]])

  tfn.routes = dict(rollouts="fixed", scoring="fixed")
  return jfn, tfn, table


def test_cross_entropy_update_matches_jax(swimmer):
  jt, pt, nu = swimmer["jt"], swimmer["pt"], swimmer["nu"]
  k, h = 12, 6
  rng = np.random.default_rng(1)
  vals = _values(rng, nu)
  var = rng.uniform(0.005, 0.2, (P, nu)).astype(np.float32)
  jcfg = jce.CEMConfig(num_trajectory=k, num_spline_points=P, n_elite=4,
                       std_initial=jnp.float32(0.3),
                       std_min=jnp.float32(0.1), horizon=h)
  pcfg = tce.CEMConfig(num_trajectory=k, num_spline_points=P, n_elite=4,
                       std_initial=0.3, std_min=0.1, horizon=h)
  jfn, tfn, table = _fixed_returns([k], seed=1)
  key = jax.random.PRNGKey(3)
  jstate = jce.CEMState(policy=jspline.SplinePolicy(
      t0=jnp.float32(0.0), dt=jnp.float32(0.02), values=jnp.asarray(vals),
      interp=0), variance=jnp.asarray(var))
  jnew, jinfo = jce.make_optimize_fn(
      jt.plan_model, None, None, jcfg, returns_fn=jfn)(
          key, swimmer["jd0"], jstate)
  noise = np.asarray(jax.random.normal(key, (k - 1, P, nu), jnp.float32))
  pstate = tce.CEMState(policy=tspline.SplinePolicy(
      t0=torch.tensor(0.0), dt=torch.tensor(0.02), values=tt(vals)),
      variance=tt(var))
  opt = tce.make_optimize_fn(pt.plan_model, None, pt.cost_spec, pcfg,
                             returns_fn=tfn)
  assert opt.routes == tfn.routes
  pnew, pinfo = opt(None, swimmer["pd0"], pstate, noise=tt(noise))
  np.testing.assert_allclose(to_np(pnew.policy.values),
                             np.asarray(jnew.policy.values), atol=TOL)
  np.testing.assert_allclose(to_np(pnew.variance), np.asarray(jnew.variance),
                             atol=TOL)
  np.testing.assert_allclose(float(pnew.policy.t0), float(jnew.policy.t0))
  np.testing.assert_allclose(float(pnew.policy.dt), float(jnew.policy.dt),
                             rtol=1e-6)
  assert int(pinfo["winner"]) == int(jinfo["winner"]) == int(
      np.argmin(table[k]))
  for key_ in ("best_return", "elite_avg_return", "failures"):
    np.testing.assert_allclose(float(pinfo[key_]), float(jinfo[key_]),
                               atol=TOL)


def test_sample_gradient_update_matches_jax(swimmer):
  jt, pt, nu = swimmer["jt"], swimmer["pt"], swimmer["nu"]
  k, n_grad, h = 12, 4, 6
  rng = np.random.default_rng(2)
  vals = _values(rng, nu)
  prev = 0.1 * rng.standard_normal((P, nu)).astype(np.float32)
  jcfg = jsg.SampleGradientConfig(
      num_trajectory=k, num_gradient=n_grad, num_spline_points=P,
      exploration=jnp.float32(0.2), gradient_filter=jnp.float32(0.7),
      horizon=h)
  pcfg = tsg.SampleGradientConfig(
      num_trajectory=k, num_gradient=n_grad, num_spline_points=P,
      exploration=0.2, gradient_filter=0.7, horizon=h)
  jfn, tfn, table = _fixed_returns([k - n_grad, n_grad], seed=2)
  # make a gradient candidate the winner
  table[n_grad][1] = -1.0
  key = jax.random.PRNGKey(4)
  jstate = jsg.SGState(policy=jspline.SplinePolicy(
      t0=jnp.float32(0.0), dt=jnp.float32(0.02), values=jnp.asarray(vals),
      interp=0), gradient=jnp.asarray(prev))
  jnew, jinfo = jsg.make_optimize_fn(
      jt.plan_model, None, None, jcfg, returns_fn=jfn)(
          key, swimmer["jd0"], jstate)
  noise = np.asarray(jax.random.normal(key, (k - n_grad - 1, P, nu),
                                       jnp.float32))
  pstate = tsg.SGState(policy=tspline.SplinePolicy(
      t0=torch.tensor(0.0), dt=torch.tensor(0.02), values=tt(vals)),
      gradient=tt(prev))
  pnew, pinfo = tsg.make_optimize_fn(
      pt.plan_model, None, pt.cost_spec, pcfg, returns_fn=tfn)(
          None, swimmer["pd0"], pstate, noise=tt(noise))
  np.testing.assert_allclose(to_np(tsg.fitness_weights(7)),
                             np.asarray(jsg._fitness_weights(7, jnp.float32)),
                             atol=TOL)
  np.testing.assert_allclose(to_np(pnew.gradient), np.asarray(jnew.gradient),
                             atol=TOL)
  assert np.abs(np.asarray(jnew.gradient)).max() > 1e-3
  np.testing.assert_allclose(to_np(pnew.policy.values),
                             np.asarray(jnew.policy.values), atol=TOL)
  np.testing.assert_allclose(to_np(pinfo["returns"]),
                             np.asarray(jinfo["returns"]), atol=TOL)
  assert int(pinfo["winner"]) == int(jinfo["winner"]) == k - n_grad + 1
  assert bool(pinfo["from_gradient"]) and bool(jinfo["from_gradient"])


def _robust_jax(jt, jd0, vals, s_cfg, r_cfg, key, jfn):
  """JAX robust iteration (jitted) plus the numbers its key gives: the
  candidates' uniforms and normals and each re-roll's OU normals."""
  m = jt.plan_model
  opt = jrobust.make_optimize_fn(
      m, lambda mm, dd: jt.residual(mm, dd, jt.residual_params),
      jt.cost_spec.cost, s_cfg, r_cfg, returns_fn=jfn)
  pol = jspline.SplinePolicy(t0=jnp.float32(0.0), dt=jnp.float32(0.02),
                             values=jnp.asarray(vals), interp=0)
  k_noise = s_cfg.num_trajectory - 1
  n_flat = r_cfg.num_candidates * r_cfg.num_repetitions
  h = s_cfg.horizon

  @jax.jit
  def run(key):
    new, info = opt(key, jd0, pol)
    k1, k2 = jax.random.split(key)
    kb, kn = jax.random.split(k1)
    u = jax.random.uniform(kb, (k_noise,))
    normals = jax.random.normal(kn, (k_noise, P, m.nu))
    flat = jax.random.split(k2, n_flat).reshape(n_flat, 2)
    xfrc = jax.vmap(lambda fk: jax.vmap(
        lambda sk: jax.random.normal(sk, (m.nbody, 6)))(
            jax.random.split(fk, h - 1)))(flat)
    return new, info, u, normals, xfrc

  return run(key)


def test_robust_update_matches_jax(swimmer):
  """Clean returns fixed (the same in both packages), the N x M noisy
  re-rolls real pipeline rollouts with the same OU noise: the same top-N,
  the same robust winner, the same averaged noisy return."""
  jt, pt, nu = swimmer["jt"], swimmer["pt"], swimmer["nu"]
  k, h = 8, 5
  rng = np.random.default_rng(3)
  vals = _values(rng, nu)
  js = jsampling.SamplingConfig(num_trajectory=k, num_spline_points=P,
                                exploration=jnp.asarray([0.3, 0.0]),
                                horizon=h)
  jr = jrobust.RobustConfig(num_candidates=3, num_repetitions=2,
                            xfrc_std=jnp.float32(0.5),
                            xfrc_rate=jnp.float32(0.1))
  ps = tsampling.SamplingConfig(k, P, 0, (0.3, 0.0), h)
  pr = trobust.RobustConfig(3, 2, 0.5, 0.1)
  jfn, tfn, table = _fixed_returns([k], seed=3)
  jnew, jinfo, u, normals, xfrc = _robust_jax(
      jt, swimmer["jd0"], vals, js, jr, jax.random.PRNGKey(5), jfn)
  opt = trobust.make_optimize_fn(
      pt.plan_model, lambda mm, dd: pt.residual(mm, dd, pt.residual_params),
      pt.cost_spec, ps, pr, returns_fn=tfn)
  assert opt.routes == dict(clean_rollouts="fixed", clean_scoring="fixed",
                            noisy_rollouts="pipeline", noisy_scoring="kernel",
                            spd_solve="kernel")
  pol = tspline.SplinePolicy(t0=torch.tensor(0.0), dt=torch.tensor(0.02),
                             values=tt(vals))
  pnew, pinfo = opt(None, swimmer["pd0"], pol, noise=tt(np.asarray(normals)),
                    u=tt(np.asarray(u)), xfrc_noise=tt(np.asarray(xfrc)))
  assert int(pinfo["winner"]) == int(jinfo["winner"])
  np.testing.assert_allclose(to_np(pnew.values), np.asarray(jnew.values),
                             atol=TOL)
  np.testing.assert_allclose(float(pinfo["best_return"]),
                             float(jinfo["best_return"]), atol=TOL)
  np.testing.assert_allclose(float(pinfo["robust_return"]),
                             float(jinfo["robust_return"]),
                             rtol=TOL_RETURN_REL)
  # the re-rolls differ from each other: the noise reached them
  assert float(pinfo["noisy_returns"].std()) > 1e-4


def test_pipeline_sampling_planner_matches_jax(swimmer):
  """The pipeline SamplingPlanner's iteration: the candidates from the same
  numbers, their returns from the batched rollouts (1e-4 relative), the
  same winner and new policy."""
  jt, pt, nu = swimmer["jt"], swimmer["pt"], swimmer["nu"]
  k, h = 4, 5
  rng = np.random.default_rng(4)
  vals = _values(rng, nu)
  jcfg = jsampling.SamplingConfig(num_trajectory=k, num_spline_points=P,
                                  exploration=jnp.asarray([0.4, 0.2]),
                                  horizon=h)
  pcfg = tsampling.SamplingConfig(k, P, 0, (0.4, 0.2), h)
  m = jt.plan_model
  opt = jsampling.make_optimize_fn(
      m, lambda mm, dd: jt.residual(mm, dd, jt.residual_params),
      jt.cost_spec.cost, jcfg, residual_fn_with_params=jt.residual)
  jpol = jspline.SplinePolicy(t0=jnp.float32(0.0), dt=jnp.float32(0.02),
                              values=jnp.asarray(vals), interp=0)
  key = jax.random.PRNGKey(6)
  jnew, jinfo = jax.jit(lambda key: opt(key, swimmer["jd0"], jpol,
                                        jt.residual_params, jt.cost_spec))(key)
  kb, kn = jax.random.split(key)
  u = np.asarray(jax.random.uniform(kb, (k - 1,)))
  normals = np.asarray(jax.random.normal(kn, (k - 1, P, nu)))
  planner = tsampling.SamplingPlanner(pt, pcfg, device="cpu")
  assert planner.routes == dict(rollouts="pipeline", spd_solve="kernel",
                                scoring="kernel")
  planner.policy = tspline.SplinePolicy(
      t0=torch.tensor(0.0), dt=torch.tensor(0.02), values=tt(vals))
  pinfo = planner.optimize(None, swimmer["pd0"], noise=tt(normals), u=tt(u))
  np.testing.assert_allclose(to_np(pinfo["returns"]),
                             np.asarray(jinfo["returns"]),
                             rtol=TOL_RETURN_REL)
  assert int(pinfo["winner"]) == int(jinfo["winner"])
  np.testing.assert_allclose(to_np(planner.policy.values),
                             np.asarray(jnew.values), atol=TOL)


class _Stand:
  """A stand-in sampler or iLQG planner for iLQS: fixed returns, a policy
  the test sets, and a record of what iLQS handed it."""

  def __init__(self, policy, config, ret, new_actions=None):
    self.policy, self.config, self.ret = policy, config, ret
    self.new_actions = new_actions
    self.seeded = None
    self.routes = {}

  def optimize(self, key, d0):
    if self.new_actions is not None:        # iLQG: record, then improve
      self.seeded = self.policy.actions
      self.policy = self.policy.replace(actions=self.new_actions)
    return {"best_return": self.ret, "host_readbacks": 1}


@pytest.mark.parametrize("ilqg_wins", [True, False])
def test_ilqs_switch_and_spline_fit_match_jax(swimmer, ilqg_wins):
  jt, pt, nu = swimmer["jt"], swimmer["pt"], swimmer["nu"]
  h = 9
  rng = np.random.default_rng(5)
  vals = _values(rng, nu)
  times = (0.12 + 0.01 * np.arange(h)).astype(np.float32)
  improved = rng.uniform(-0.9, 0.9, (h, nu)).astype(np.float32)
  s_ret, i_ret = (2.0, 1.5) if ilqg_wins else (1.0, 1.5)
  cfg = types.SimpleNamespace(num_spline_points=P, interp=0, horizon=h)
  icfg = types.SimpleNamespace(horizon=h)

  jp = object.__new__(jilqs.ILQSPlanner)
  jp.m, jp.active = jt.plan_model, "sampling"
  jp.sampler = _Stand(jspline.SplinePolicy(
      t0=jnp.float32(0.12), dt=jnp.float32(0.03), values=jnp.asarray(vals),
      interp=0), cfg, s_ret)
  jp.ilqg = _Stand(types.SimpleNamespace(
      actions=None, times=jnp.asarray(times),
      replace=lambda **kw: _replace(jp.ilqg.policy, **kw)), icfg, i_ret,
      new_actions=jnp.asarray(improved))
  jp._spline_fit = lambda a, t, t0, dt: jspline.fit(a, t, t0, dt, P, 0)
  jinfo = jp.optimize(jax.random.PRNGKey(0), swimmer["jd0"])

  tp = object.__new__(tilqs.ILQSPlanner)
  tp.m, tp.active = pt.plan_model, "sampling"
  tp.sampler = _Stand(tspline.SplinePolicy(
      t0=torch.tensor(0.12), dt=torch.tensor(0.03), values=tt(vals)), cfg,
      torch.tensor(s_ret))
  tp.ilqg = _Stand(types.SimpleNamespace(
      actions=None, times=tt(times),
      replace=lambda **kw: _replace(tp.ilqg.policy, **kw)), icfg,
      torch.tensor(i_ret), new_actions=tt(improved))
  tinfo = tp.optimize(None, swimmer["pd0"])

  assert tinfo["active"] == jinfo["active"] == (
      "ilqg" if ilqg_wins else "sampling")
  assert tinfo["best_return"] == jinfo["best_return"]
  assert tinfo["host_readbacks"] == 3     # two of its own, one of iLQG's
  np.testing.assert_allclose(to_np(tp.ilqg.seeded),
                             np.asarray(jp.ilqg.seeded), atol=TOL)
  np.testing.assert_allclose(to_np(tp.sampler.policy.values),
                             np.asarray(jp.sampler.policy.values), atol=TOL)
  if ilqg_wins:
    assert np.abs(np.asarray(jp.sampler.policy.values) - vals).max() > 1e-2


def _replace(ns, **kw):
  out = types.SimpleNamespace(**vars(ns))
  for k, v in kw.items():
    setattr(out, k, v)
  return out


def test_planner_names_and_registry():
  assert tbase.PLANNER_NAMES == jbase.PLANNER_NAMES
  pt = tregistry.get_task("Cartpole", device="cpu")
  built = {name: type(tbase.make_planner(pt, name, device="cpu")).__name__
           for name in ("Sampling", "Cross Entropy", "Sample Gradient",
                        "Robust Sampling", "Sampling Lane")}
  assert built == {"Sampling": "SamplingPlanner",
                   "Cross Entropy": "CrossEntropyPlanner",
                   "Sample Gradient": "SampleGradientPlanner",
                   "Robust Sampling": "RobustPlanner",
                   "Sampling Lane": "LaneSamplingPlanner"}
  assert type(tbase.make_planner(pt, "Gradient", device="cpu")).__name__ == \
      "GradientPlanner"
  with pytest.raises(ValueError, match="unknown planner"):
    tbase.make_planner(pt, "Nope", device="cpu")
  p = tbase.make_planner(pt, "Cross Entropy", device="cpu")
  assert not tbase.is_ranked(p)
  p.last_info = {"returns": None}
  assert tbase.is_ranked(p)


def test_gates_raise_instead_of_falling_back():
  """No quiet fallback: the quadruped (contacts) cannot take the pipeline
  physics, so a pipeline route there raises naming what is missing; a task
  without lane hooks cannot take the lane scorer."""
  quad = tregistry.get_task("Quadruped Flat", device="cpu")
  with pytest.raises(NotImplementedError, match="contacts"):
    tsampling.SamplingPlanner(quad, device="cpu")
  with pytest.raises(NotImplementedError, match="contacts"):
    tce.CrossEntropyPlanner(quad, lane=False, device="cpu")
  with pytest.raises(NotImplementedError, match="contacts"):
    trobust.RobustPlanner(quad, lane=True, device="cpu")
  bare = tregistry.get_task("Cartpole", device="cpu")
  bare.residual_from_rollout = None
  del bare.residual_from_rollout
  no_lane = types.SimpleNamespace(**{k: getattr(bare, k) for k in (
      "plan_model", "model", "cost_spec", "residual_params", "device",
      "config", "residual")})
  with pytest.raises(NotImplementedError, match="lane=False"):
    tsg.SampleGradientPlanner(no_lane, lane=True, device="cpu")


# ---- behaviour on the port's own noise: the cost goes down ----

H_B = 10


@pytest.fixture(scope="module")
def cartpole():
  pt = tregistry.get_task("Cartpole", device="cpu")
  d0 = pt.make_data().replace(qpos=torch.tensor([0.5, 3.0]))
  return pt, d0


def _planner(pt, name):
  scfg = tsampling.SamplingConfig(num_trajectory=8, num_spline_points=P,
                                  exploration=(0.5, 0.0), horizon=H_B)
  if name == "cross_entropy":
    return tce.CrossEntropyPlanner(pt, tce.make_config(pt).replace(
        num_trajectory=16, num_spline_points=P, horizon=H_B, n_elite=4),
        lane=True, device="cpu")
  if name == "sample_gradient":
    return tsg.SampleGradientPlanner(pt, tsg.make_config(pt).replace(
        num_trajectory=16, num_gradient=4, num_spline_points=P,
        horizon=H_B, exploration=0.5), lane=True, device="cpu")
  if name == "robust":
    return trobust.RobustPlanner(pt, scfg, trobust.RobustConfig(2, 2),
                                 lane=True, device="cpu")
  if name == "sampling":
    return tsampling.SamplingPlanner(pt, scfg, device="cpu")
  return tilqs.ILQSPlanner(pt, lane=True, device="cpu", sampler_config=scfg)


@pytest.mark.parametrize("name", ["cross_entropy", "sample_gradient",
                                  "robust", "sampling", "ilqs"])
def test_cost_goes_down_over_three_iterations(cartpole, name):
  pt, d0 = cartpole
  planner = _planner(pt, name)
  gen = torch.Generator().manual_seed(1)
  infos = [planner.optimize(gen, d0) for _ in range(3)]
  best = [float(i["best_return"]) for i in infos]
  first = float(infos[0]["returns"][0]) if "returns" in infos[0] else best[0]
  assert all(np.isfinite(best)) and max(best) < 1e6
  assert best[-1] < first - 1e-3, (first, best)
  action = planner.action(0.0)
  assert action.shape == (1,) and bool(torch.isfinite(action).all())
