"""Norm gradients / Hessians, the Gauss-Newton cost expansion and the
forward-mode dynamics Jacobians of the port against the JAX package's.

Tolerances: 1e-5 on the norm derivatives (same float32 formulas), 1e-4 abs
/ 1e-3 rel on A, B and the cost expansions (both sides are exact
forward-mode AD through float32 pipelines that sum in different orders; the
entries reach ~2 for A and ~70 for cxx on Swimmer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.costs import norms as jnorms
from mujoco_mpc_tpu.planners import derivatives as JD
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.costs import norms as tnorms
from mujoco_mpc_tpu_torch.planners import derivatives as TD
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

NORMS = [(-1, []), (0, []), (1, [0.3, 1.5]), (2, [0.1]), (3, [0.7]),
         (5, [2.5]), (6, [0.2]), (7, [0.2, 1.5]), (8, [0.3]), (8, [0.0])]


@pytest.mark.parametrize("ntype,params", NORMS)
def test_norm_grad_and_hessian_match_jax(ntype, params):
  rng = np.random.default_rng(ntype + 5)
  x = rng.standard_normal((7, 3)).astype(np.float32)
  x[0] = 0.0
  p = np.zeros(3, np.float32)
  p[:len(params)] = params
  g = tnorms.norm_grad(tt(x), ntype, tt(p))
  h = tnorms.norm_hess_diag(tt(x), ntype, tt(p))
  np.testing.assert_allclose(
      to_np(g), np.asarray(jnorms.norm_grad(jnp.asarray(x), ntype,
                                            jnp.asarray(p))),
      atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(
      to_np(h), np.asarray(jnorms.norm_hess_diag(jnp.asarray(x), ntype,
                                                 jnp.asarray(p))),
      atol=1e-5, rtol=1e-5)
  assert h.shape == (7, 3, 3)


@pytest.mark.parametrize("name", ["Cartpole", "Swimmer", "Quadruped Flat"])
@pytest.mark.parametrize("risk", [0.0, 0.7])
def test_cost_grad_hess_matches_jax(name, risk):
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  jcs = jt.cost_spec.replace(risk=jnp.float32(risk))
  pcs = pt.cost_spec.replace(risk=tt(risk))
  rng = np.random.default_rng(1)
  r = (0.3 * rng.standard_normal((4, jcs.num_residual))).astype(np.float32)
  g, h = pcs.cost_grad_hess(tt(r))
  jg, jh = jcs.cost_grad_hess(jnp.asarray(r))
  scale = max(1.0, float(np.abs(np.asarray(jh)).max()))
  np.testing.assert_allclose(to_np(g), np.asarray(jg), atol=1e-5 * scale,
                             rtol=1e-5)
  np.testing.assert_allclose(to_np(h), np.asarray(jh), atol=1e-5 * scale,
                             rtol=1e-5)


def _trajectory(jt, horizon, seed):
  jm = jt.plan_model
  rng = np.random.default_rng(seed)
  d0 = jt.make_data()
  base = np.concatenate([np.asarray(d0.qpos), np.zeros(jm.nv)])
  states = base[None] + 0.3 * rng.standard_normal((horizon, jm.nq + jm.nv))
  actions = rng.uniform(-1.2, 1.2, (horizon, jm.nu))
  times = 0.01 * np.arange(horizon)
  return (states.astype(np.float32), actions.astype(np.float32),
          times.astype(np.float32))


@pytest.fixture(scope="module")
def swimmer():
  return (jregistry.get_task("Swimmer"),
          tregistry.get_task("Swimmer", device="cpu"))


@pytest.mark.parametrize("skip", [1, 3])
def test_trajectory_derivatives_match_jax_on_swimmer(swimmer, skip):
  jt, pt = swimmer
  jm, pm = jt.plan_model, pt.plan_model
  s, u, t = _trajectory(jt, 6, seed=skip)
  jout = jax.jit(lambda s, u, t: JD.trajectory_derivatives(
      jm, jt.make_data(),
      lambda m, d: jt.residual(m, d, jt.residual_params), jt.cost_spec,
      s, u, t, skip=skip))(jnp.asarray(s), jnp.asarray(u), jnp.asarray(t))
  pout = TD.trajectory_derivatives(
      pm, pt.make_data(),
      lambda m, d: pt.residual(m, d, pt.residual_params), pt.cost_spec,
      tt(s), tt(u), tt(t), skip=skip)
  names = "a b cx cu cxx cxu cuu".split()
  shapes = [(5, 16, 16), (5, 16, 5), (6, 16), (6, 5), (6, 16, 16),
            (6, 16, 5), (6, 5, 5)]
  for n, shape, want, got in zip(names, shapes, jout, pout):
    assert tuple(got.shape) == shape and got.dtype == torch.float32, n
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-3, err_msg=n)
  assert float(np.abs(np.asarray(jout[0])).max()) > 1.0   # not trivial


@pytest.mark.parametrize("skip", [1, 2])
def test_model_and_cost_derivatives_match_jax_on_cartpole(skip):
  """Cartpole's planning model integrates with RK4: the Jacobians pass
  through four forward evaluations."""
  jt = jregistry.get_task("Cartpole")
  pt = tregistry.get_task("Cartpole", device="cpu")
  jm, pm = jt.plan_model, pt.plan_model
  s, u, t = _trajectory(jt, 5, seed=7)
  ja, jb = jax.jit(lambda s, u, t: JD.model_derivatives(
      jm, jt.make_data(), s, u, t, skip=skip))(
          jnp.asarray(s), jnp.asarray(u), jnp.asarray(t))
  pa, pb = TD.model_derivatives(pm, pt.make_data(), tt(s), tt(u), tt(t),
                                skip=skip)
  np.testing.assert_allclose(to_np(pa), np.asarray(ja), atol=1e-4, rtol=1e-3)
  np.testing.assert_allclose(to_np(pb), np.asarray(jb), atol=1e-4, rtol=1e-3)
  if skip == 1:
    jc = jax.jit(lambda s, u, t: JD.cost_derivatives(
        jm, jt.make_data(),
        lambda m, d: jt.residual(m, d, jt.residual_params), jt.cost_spec,
        s, u, t))(jnp.asarray(s), jnp.asarray(u), jnp.asarray(t))
    pc = TD.cost_derivatives(
        pm, pt.make_data(),
        lambda m, d: pt.residual(m, d, pt.residual_params), pt.cost_spec,
        tt(s), tt(u), tt(t))
    for want, got in zip(jc, pc):
      np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4,
                                 rtol=1e-3)


def test_state_add_and_diff_match_jax_on_a_free_joint_model():
  """The quaternion tangent: Quadruped Flat's free joint."""
  jm = jregistry.get_task("Quadruped Flat").plan_model
  pm = tregistry.get_task("Quadruped Flat", device="cpu").plan_model
  assert TD.ndx(pm) == JD.ndx(jm) == 36
  rng = np.random.default_rng(4)
  s1 = rng.standard_normal(37).astype(np.float32)
  s1[3:7] /= np.linalg.norm(s1[3:7])
  dx = (0.3 * rng.standard_normal(36)).astype(np.float32)
  s2 = TD.state_add(pm, tt(s1), tt(dx))
  np.testing.assert_allclose(
      to_np(s2), np.asarray(JD.state_add(jm, jnp.asarray(s1),
                                         jnp.asarray(dx))), atol=1e-5)
  back = TD.state_diff(pm, s2, tt(s1))
  np.testing.assert_allclose(to_np(back), dx, atol=1e-5)
  np.testing.assert_allclose(
      to_np(back), np.asarray(JD.state_diff(jm, jnp.asarray(to_np(s2)),
                                            jnp.asarray(s1))), atol=1e-5)
  # batched over leading axes, as the line searches use it
  many = TD.state_diff(pm, s2[None, None].repeat(2, 3, 1), tt(s1)[None])
  assert many.shape == (2, 3, 36)
  np.testing.assert_allclose(to_np(many[1, 2]), dx, atol=1e-5)
