"""Port vs JAX: norms, cost spec, splines, candidate noise (1e-5: same
float32 formulas, library functions differ in the last bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import spline as jspline
from mujoco_mpc_tpu.costs import norms as jnorms
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch import spline as tspline
from mujoco_mpc_tpu_torch.costs import norms as tnorms
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

TOL = 1e-5

NORM_CASES = [
    (tnorms.NormType.NULL, []), (tnorms.NormType.QUADRATIC, []),
    (tnorms.NormType.L22, [0.3, 1.5]), (tnorms.NormType.L2, [0.1]),
    (tnorms.NormType.COSH, [0.7]), (tnorms.NormType.POWER_LOSS, [1.5]),
    (tnorms.NormType.SMOOTH_ABS, [0.05]),
    (tnorms.NormType.SMOOTH_ABS2, [0.2, 1.7]),
    (tnorms.NormType.RECTIFY, [0.4])]


@pytest.mark.parametrize("ntype,params", NORM_CASES,
                         ids=[c[0].name for c in NORM_CASES])
def test_norm_value_matches_jax(ntype, params):
  assert [int(t) for t in tnorms.NormType] == \
      [int(t) for t in jnorms.NormType]
  rng = np.random.default_rng(int(ntype) + 2)
  x = rng.standard_normal((5, 7, 4)).astype(np.float32)
  p = np.asarray(params, np.float32)
  want = np.asarray(jnorms.norm_value(jnp.asarray(x), int(ntype),
                                      jnp.asarray(p)))
  got = to_np(tnorms.norm_value(tt(x), int(ntype), tt(p)))
  np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
  assert tnorms.num_norm_params(ntype) == jnorms.num_norm_params(ntype)
  # the lane-layout term cost (rows on the first axis) agrees as well
  rows = [tt(x[..., i].reshape(-1)) for i in range(x.shape[-1])]
  pq = np.concatenate([p, np.ones(2, np.float32)])[:2]
  lane = to_np(tstep.lane_term_cost(rows, int(ntype), tt(pq[0]), tt(pq[1])))
  np.testing.assert_allclose(lane, want.reshape(-1), atol=TOL, rtol=TOL)


def test_rectify_zero_temperature_is_relu():
  x = np.linspace(-2, 2, 9, dtype=np.float32)[:, None]
  p = np.zeros(1, np.float32)
  want = np.asarray(jnorms.norm_value(jnp.asarray(x), 8, jnp.asarray(p)))
  got = to_np(tnorms.norm_value(tt(x), 8, tt(p)))
  np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("risk", [0.0, 0.3])
def test_cost_spec_matches_jax_on_quadruped(risk):
  jt = jregistry.get_task("Quadruped Flat")
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  jspec = jt.cost_spec.replace(risk=jnp.asarray(risk, jnp.float32))
  pspec = pt.cost_spec.replace(risk=torch.tensor(risk))
  assert pspec.term_names == jspec.term_names
  assert pspec.num_term == 9 and pspec.num_residual == 42
  rng = np.random.default_rng(4)
  res = (0.3 * rng.standard_normal((6, 42))).astype(np.float32)
  np.testing.assert_allclose(
      to_np(pspec.cost_terms(tt(res))),
      np.asarray(jspec.cost_terms(jnp.asarray(res))), atol=TOL, rtol=TOL)
  np.testing.assert_allclose(
      to_np(pspec.cost_terms(tt(res), weighted=False)),
      np.asarray(jspec.cost_terms(jnp.asarray(res), weighted=False)),
      atol=TOL, rtol=TOL)
  np.testing.assert_allclose(
      to_np(pspec.cost(tt(res))), np.asarray(jspec.cost(jnp.asarray(res))),
      atol=TOL, rtol=TOL)
  j2 = jspec.set_weight("Balance", 0.77)
  p2 = pspec.set_weight("Balance", 0.77)
  np.testing.assert_allclose(to_np(p2.weights), np.asarray(j2.weights))
  assert float(pspec.weights[4]) != pytest.approx(0.77)   # not in place


def test_cost_spec_parsers_match_jax_on_compiled_model():
  """The duck-typed parsers read an MjModel like the JAX ones."""
  from mujoco_mpc_tpu.costs import spec as jcs
  from mujoco_mpc_tpu_torch.costs import spec as tcs
  mjm = jregistry.get_task("Cartpole").mjm
  js, ps = jcs.parse_cost_spec(mjm), tcs.parse_cost_spec(mjm, device="cpu")
  assert (ps.term_names, ps.norm_types, ps.dims) == \
      (js.term_names, js.norm_types, js.dims)
  np.testing.assert_allclose(to_np(ps.weights), np.asarray(js.weights))
  np.testing.assert_allclose(to_np(ps.norm_params),
                             np.asarray(js.norm_params))
  np.testing.assert_allclose(
      to_np(tcs.parse_residual_params(mjm, device="cpu")),
      np.asarray(jcs.parse_residual_params(mjm)))
  assert tcs.get_number_or_default(mjm, "agent_horizon", 0.0) == \
      jcs.get_number_or_default(mjm, "agent_horizon", 0.0)
  assert tcs.get_number_or_default(mjm, "no_such", 7.0) == 7.0


def _policies(interp, rng, batch=()):
  vals = rng.standard_normal(batch + (6, 3)).astype(np.float32)
  jp = jspline.SplinePolicy(t0=jnp.asarray(0.2, jnp.float32),
                            dt=jnp.asarray(0.05, jnp.float32),
                            values=jnp.asarray(vals), interp=interp)
  pp = convert.policy_from_numpy(0.2, 0.05, vals, interp, device="cpu")
  return jp, pp


@pytest.mark.parametrize("interp", [0, 1, 2])
def test_spline_sample_resample_slide_match_jax(interp):
  rng = np.random.default_rng(interp)
  jp, pp = _policies(interp, rng)
  for t in (0.0, 0.2, 0.26, 0.31, 0.449, 0.45, 0.9):
    np.testing.assert_allclose(
        to_np(tspline.sample(pp, t)),
        np.asarray(jspline.sample(jp, jnp.asarray(t, jnp.float32))),
        atol=TOL, err_msg=f"t={t}")
  jr = jspline.resample(jp, jnp.asarray(0.27, jnp.float32),
                        jnp.asarray(0.35, jnp.float32))
  pres = tspline.resample(pp, 0.27, 0.35)
  np.testing.assert_allclose(to_np(pres.values), np.asarray(jr.values),
                             atol=TOL)
  np.testing.assert_allclose(to_np(pres.dt), np.asarray(jr.dt), atol=1e-7)
  np.testing.assert_allclose(to_np(pres.t0), np.asarray(jr.t0), atol=1e-7)
  js = jspline.slide(jp, jnp.asarray(0.33, jnp.float32))
  ps = tspline.slide(pp, 0.33)
  np.testing.assert_allclose(to_np(ps.values), np.asarray(js.values),
                             atol=0)
  np.testing.assert_allclose(to_np(ps.t0), np.asarray(js.t0), atol=1e-7)


def test_spline_sample_is_batched_over_leading_axes():
  rng = np.random.default_rng(9)
  jp, pp = _policies(1, rng, batch=(4,))
  got = to_np(tspline.sample(pp, 0.31))
  want = np.asarray(jspline.sample(jp, jnp.asarray(0.31, jnp.float32)))
  assert got.shape == (4, 3)
  np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("std2", [0.0, 0.3])
def test_add_noise_with_injected_numbers_matches_jax(std2):
  jt = jregistry.get_task("Quadruped Flat")
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  jm, pm = jt.plan_model, pt.plan_model
  rng = np.random.default_rng(11)
  k, p = 12, 3
  values = rng.uniform(-0.5, 0.5, (p, jm.nu)).astype(np.float32)
  noise = rng.standard_normal((k, p, jm.nu)).astype(np.float32)
  u = rng.uniform(0, 1, k).astype(np.float32)
  expl = (0.04, std2)
  got = to_np(tsampling.add_noise(None, tt(values), pm, expl, k,
                                  noise=tt(noise), u=tt(u)))
  # the JAX candidates rebuilt from the same numbers (the three lines of
  # planners/sampling.py:add_noise after the draws)
  scale = 0.5 * (jm.actuator_ctrlrange[:, 1] - jm.actuator_ctrlrange[:, 0])
  use2 = (jnp.asarray(u) < jsampling.STD2_PROPORTION) & (expl[1] > 0)
  std = jnp.where(use2, expl[1], expl[0])
  want = jnp.clip(jnp.asarray(values)[None] + jnp.asarray(noise) *
                  scale[None, None, :] * std[:, None, None],
                  jm.actuator_ctrlrange[:, 0], jm.actuator_ctrlrange[:, 1])
  np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
  assert tsampling.STD2_PROPORTION == jsampling.STD2_PROPORTION


def test_add_noise_draws_from_generator_reproducibly():
  pt = tregistry.get_task("Cartpole", device="cpu")
  values = torch.zeros(4, 1)
  a = tsampling.add_noise(torch.Generator().manual_seed(3), values,
                          pt.plan_model, (0.5, 0.0), 64)
  b = tsampling.add_noise(torch.Generator().manual_seed(3), values,
                          pt.plan_model, (0.5, 0.0), 64)
  assert a.shape == (64, 4, 1) and torch.equal(a, b)
  assert float(a.abs().max()) <= 1.0            # clipped to ctrlrange
  assert 0.3 < float(a.std()) < 0.6             # std 0.5 * half-range 1


@pytest.mark.parametrize("name", ["Cartpole", "Quadruped Flat"])
def test_initial_policy_and_config_match_jax(name):
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  jc, pc = jsampling.make_config(jt), tsampling.make_config(pt)
  assert (pc.num_trajectory, pc.num_spline_points, pc.interp, pc.horizon,
          pc.sliding_plan) == (jc.num_trajectory, jc.num_spline_points,
                               jc.interp, jc.horizon, jc.sliding_plan)
  np.testing.assert_allclose(np.asarray(pc.exploration),
                             np.asarray(jc.exploration), atol=1e-7)
  assert tsampling.node_spacing(pt.plan_model, pc) == pytest.approx(
      jsampling.node_spacing(jt.plan_model, jc), rel=1e-6)
  jp = jsampling.initial_policy(jt.plan_model, jc)
  pp = tsampling.initial_policy(pt.plan_model, pc, device="cpu")
  np.testing.assert_allclose(to_np(pp.values), np.asarray(jp.values),
                             atol=1e-7)
  np.testing.assert_allclose(to_np(pp.dt), np.asarray(jp.dt), rtol=1e-6)
  assert pp.interp == jp.interp and float(pp.t0) == float(jp.t0)
