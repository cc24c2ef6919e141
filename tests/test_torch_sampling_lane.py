"""Port vs JAX: the slice as a whole — candidates in, returns and winner
out — through `ops/sampling_lane.py` on the CPU (plain versions).

Cartpole goes through the JAX package's Pallas kernel in interpret mode.
The quadruped's JAX returns are assembled from its `step_array` chained
over the horizon, `lane_term_cost` and the weights (the formula of
`sampling_lane.returns_fn`), eagerly: dispatching that step through the
Pallas interpreter, or compiling it for the CPU, takes many minutes.
Tolerance on returns: 1e-4 relative, and the same winner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import spline as jspline
from mujoco_mpc_tpu.ops import sampling_lane as jlane
from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.physics import collision as jcoll
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.ops import sampling_lane as tlane
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

TOL_RETURNS_REL = 1e-4


CART_K, CART_P, CART_H = 8, 4, 10


def _cartpole_candidates(rng, k, p):
  return rng.uniform(-1.2, 1.2, (k, p, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def cartpole():
  """Both tasks and ONE JAX scorer (its Pallas kernel, interpret mode, with
  the horizon as an in-kernel loop so the CPU compile stays short)."""
  jt = jregistry.get_task("Cartpole")
  pt = tregistry.get_task("Cartpole", device="cpu")
  jcfg = jsampling.SamplingConfig(
      num_trajectory=CART_K, num_spline_points=CART_P,
      exploration=jnp.asarray([0.5, 0.0]), horizon=CART_H)
  pcfg = tsampling.SamplingConfig(CART_K, CART_P, 0, (0.5, 0.0), CART_H)
  jfn = jlane.make_lane_returns_fn(jt, jcfg, interpret=True, unroll=False)
  return dict(jt=jt, pt=pt, jcfg=jcfg, pcfg=pcfg, jfn=jfn)


def test_cartpole_returns_match_jax_pallas_interpret(cartpole):
  k, p = CART_K, CART_P
  jt, pt, pcfg = cartpole["jt"], cartpole["pt"], cartpole["pcfg"]
  rng = np.random.default_rng(0)
  cand = _cartpole_candidates(rng, k, p)
  qpos = np.array([0.3, 2.6], np.float32)
  qvel = np.array([-0.4, 1.1], np.float32)
  jd0 = jt.make_data().replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                               time=jnp.asarray(0.25, jnp.float32))
  pd0 = pt.make_data().replace(qpos=tt(qpos), qvel=tt(qvel),
                               time=torch.tensor(0.25))
  want = np.asarray(cartpole["jfn"](jnp.asarray(cand), jd0))
  got = to_np(tlane.make_lane_returns_fn(pt, pcfg)(tt(cand), pd0))
  assert got.shape == (k,)
  np.testing.assert_allclose(got, want, rtol=TOL_RETURNS_REL)
  assert int(got.argmin()) == int(want.argmin())


def test_cartpole_risk_sensitive_and_live_weights_match_jax(cartpole):
  """risk != 0 and weights handed in at call time reach the returns."""
  k, p = CART_K, CART_P
  jt, pt, pcfg = cartpole["jt"], cartpole["pt"], cartpole["pcfg"]
  cand = _cartpole_candidates(np.random.default_rng(1), k, p)
  jspec = jt.cost_spec.set_weight("Velocity", 0.7).replace(
      risk=jnp.asarray(0.2, jnp.float32))
  pspec = pt.cost_spec.set_weight("Velocity", 0.7).replace(
      risk=torch.tensor(0.2))
  want = np.asarray(cartpole["jfn"](
      jnp.asarray(cand), jt.make_data(), jt.residual_params, jspec))
  got = to_np(tlane.make_lane_returns_fn(pt, pcfg)(
      tt(cand), pt.make_data(), pt.residual_params, pspec))
  np.testing.assert_allclose(got, want, rtol=TOL_RETURNS_REL)


def _quadruped_jax_returns(jt, cand, jd0, horizon, p, risk0=True):
  """returns_fn's formula on step_array chained over the horizon."""
  spec = jt.lane_residual_spec()
  m = jt.plan_model
  kern = jstep.build_rollout_kernel(
      m, horizon, p, interpret=True, contact_types=(jcoll.SPHERE,),
      contact_geoms=jt.plan_contact_geoms, residual_fn=spec["fn"],
      residual_dim=spec["dim"], naux=spec["naux"])
  k = cand.shape[0]
  values = jnp.asarray(cand.reshape(k, -1).T)
  qp = jnp.tile(jd0.qpos[:, None], (1, k))
  qv = jnp.tile(jd0.qvel[:, None], (1, k))
  aux = jnp.tile(spec["make_aux"](jd0, jt.residual_params)[:, None], (1, k))
  cs = jt.cost_spec
  sums = [0.0] * cs.num_term
  rows_all = []
  with jax.disable_jit():
    for t in range(horizon):
      node = min(int(t * p / max(horizon - 1, 1)), p - 1)
      ctrl = values[node * m.nu:(node + 1) * m.nu]
      qp, qv, res = kern.step_array(qp, qv, ctrl, t, aux)
      rows_all.append(res)
      off = 0
      for n, (ntype, dim) in enumerate(zip(cs.norm_types, cs.dims)):
        sums[n] = sums[n] + jstep.lane_term_cost(
            [res[off + i] for i in range(dim)], ntype,
            cs.norm_params[n, 0], cs.norm_params[n, 1])
        off += dim
  term_sums = jnp.stack(sums)
  returns = jnp.sum(cs.weights[:, None] * term_sums, axis=0) / horizon
  final = jnp.concatenate([qp, qv])
  returns = jnp.where(jnp.all(jnp.isfinite(final), axis=0), returns, 1e6)
  return np.asarray(returns), np.asarray(jnp.stack(rows_all))


def test_quadruped_returns_match_jax():
  k, p, horizon = 8, 3, 4
  jt = jregistry.get_task("Quadruped Flat")
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  rng = np.random.default_rng(2)
  home = np.asarray(pt.home_qpos[7:], np.float32)
  lo = to_np(pt.plan_model.actuator_ctrlrange[:, 0])
  hi = to_np(pt.plan_model.actuator_ctrlrange[:, 1])
  cand = home[None, None] + 0.04 * 0.5 * (hi - lo) * rng.standard_normal(
      (k, p, 12)).astype(np.float32)
  cand = np.clip(cand, lo, hi).astype(np.float32)
  jd0 = jt.make_data().replace(time=jnp.asarray(0.4, jnp.float32))
  pd0 = pt.make_data().replace(time=torch.tensor(0.4))
  want, want_rows = _quadruped_jax_returns(jt, cand, jd0, horizon, p)
  pcfg = tsampling.SamplingConfig(k, p, 0, (0.04, 0.0), horizon)
  # cost-sum mode (risk-neutral: the main path)
  fn = tlane.make_lane_returns_fn(pt, pcfg, contact_types=(GEOM_SPHERE,))
  assert fn.kernel.mode == tstep.MODE_COST_SUMS
  got = to_np(fn(tt(cand), pd0))
  np.testing.assert_allclose(got, want, rtol=TOL_RETURNS_REL)
  assert int(got.argmin()) == int(want.argmin())
  # residual-row mode (risk-sensitive cost) scores the same rows
  pt.cost_spec = pt.cost_spec.replace(risk=torch.tensor(0.5))
  fn_r = tlane.make_lane_returns_fn(pt, pcfg, contact_types=(GEOM_SPHERE,))
  assert fn_r.kernel.mode == tstep.MODE_RESIDUALS
  got_r = to_np(fn_r(tt(cand), pd0))
  jspec = jt.cost_spec.replace(risk=jnp.asarray(0.5, jnp.float32))
  want_r = np.asarray(jnp.mean(
      jspec.cost(jnp.moveaxis(jnp.asarray(want_rows), 1, -1)), axis=0))
  np.testing.assert_allclose(got_r, want_r, rtol=TOL_RETURNS_REL)


def test_divergent_candidates_are_poisoned():
  pt = tregistry.get_task("Cartpole", device="cpu")
  pcfg = tsampling.SamplingConfig(4, 2, 0, (0.5, 0.0), 5)
  fn = tlane.make_lane_returns_fn(pt, pcfg)
  cand = np.zeros((4, 2, 1), np.float32)
  cand[2] = np.nan
  got = to_np(fn(tt(cand), pt.make_data()))
  assert got[2] == 1e6 and np.isfinite(got).all()
  assert (got[[0, 1, 3]] < 1e6).all()


def test_optimize_with_injected_noise_matches_jax_winner(cartpole):
  """One predictive-sampling iteration: resample, the same candidates,
  the same returns, the same winner and new policy."""
  k, p, horizon = CART_K, CART_P, CART_H
  jt, pt = cartpole["jt"], cartpole["pt"]
  jcfg, pcfg = cartpole["jcfg"], cartpole["pcfg"]
  rng = np.random.default_rng(4)
  noise = rng.standard_normal((k - 1, p, 1)).astype(np.float32)
  u = rng.uniform(0, 1, k - 1).astype(np.float32)
  start = rng.uniform(-0.5, 0.5, (p, 1)).astype(np.float32)
  ppol = tsampling.initial_policy(pt.plan_model, pcfg, "cpu").replace(
      values=tt(start))
  pd0 = pt.make_data().replace(time=torch.tensor(0.013))
  new_policy, info = tlane.make_lane_optimize_fn(pt, pcfg)(
      None, pd0, ppol, noise=tt(noise), u=tt(u))
  # JAX: the same steps with the same numbers
  jpol = jsampling.initial_policy(jt.plan_model, jcfg).replace(
      values=jnp.asarray(start))
  jd0 = jt.make_data().replace(time=jnp.asarray(0.013, jnp.float32))
  jpol = jspline.resample(jpol, jd0.time,
                          (horizon - 1) * jt.plan_model.opt.timestep)
  scale = 0.5 * (jt.plan_model.actuator_ctrlrange[:, 1] -
                 jt.plan_model.actuator_ctrlrange[:, 0])
  noisy = jnp.clip(jpol.values[None] + jnp.asarray(noise) *
                   scale[None, None, :] * 0.5,
                   jt.plan_model.actuator_ctrlrange[:, 0],
                   jt.plan_model.actuator_ctrlrange[:, 1])
  jcand = jnp.concatenate([jpol.values[None], noisy], axis=0)
  want = np.asarray(cartpole["jfn"](jcand, jd0))
  np.testing.assert_allclose(to_np(info["returns"]), want,
                             rtol=TOL_RETURNS_REL)
  assert int(info["winner"]) == int(want.argmin())
  np.testing.assert_allclose(to_np(new_policy.values),
                             np.asarray(jcand[int(want.argmin())]),
                             atol=1e-6)
  assert float(info["best_return"]) <= float(info["nominal_return"])


def test_ten_iterations_lower_the_cartpole_nominal_return():
  """Behaviour with the port's own generator: the winner becomes the
  nominal, so the nominal return never rises and ends lower."""
  pt = tregistry.get_task("Cartpole", device="cpu")
  cfg = tsampling.SamplingConfig(24, 4, 0, (0.5, 0.0), 41)
  planner = tlane.LaneSamplingPlanner(pt, cfg, device="cpu")
  gen = torch.Generator().manual_seed(0)
  d0 = pt.make_data().replace(qpos=torch.tensor([0.3, 2.2]),
                              qvel=torch.tensor([0.0, 1.0]))
  nominal = []
  for _ in range(10):
    info = planner.optimize(gen, d0)
    assert float(info["best_return"]) <= float(info["nominal_return"])
    nominal.append(float(info["nominal_return"]))
  assert all(b <= a + 1e-6 for a, b in zip(nominal, nominal[1:])), nominal
  assert float(planner.last_info["best_return"]) < nominal[0] - 0.1
  action = planner.action(0.0)
  assert action.shape == (1,) and -1.0 <= float(action) <= 1.0


def test_planner_refuses_a_missing_device():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  pt = tregistry.get_task("Cartpole", device="cpu")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tlane.LaneSamplingPlanner(pt)            # default device is "cuda"


@pytest.mark.cuda
def test_cuda_wrapper_matches_plain_on_the_card():
  """Needs the card: the CUDA kernel against its plain version (the full
  comparison is chip_smoke.py; run this with `pytest -m cuda`)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  pt = tregistry.get_task("Cartpole", device="cuda")
  kern = tstep.build_rollout_kernel(pt.plan_model, 10, 2)
  rng = np.random.default_rng(0)
  args = [tt(rng.standard_normal(s)).cuda() for s in ((2, 64), (2, 64),
                                                      (2, 64))]
  before = tstep.launch_count
  got = kern(*args)
  assert tstep.launch_count == before + 1
  torch.testing.assert_close(got, kern.plain(*args), atol=2e-4, rtol=0)
