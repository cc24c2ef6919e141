"""The port's estimators (estimators/) against the JAX package's on
Cartpole, from the same inputs: one EKF measurement and one EKF prediction
from the same (x, P, ctrl, y), one UKF update, and the Batch estimator
over 5 updates at windows 3 and 32 (BASELINE's, banded) from the same
history. The JAX side is jitted (its own jitted update functions) once a
session (tests/torch_port_helpers once_a_session).

Tolerances: the EKF's and UKF's state 1e-5 absolute and covariance 1e-4
relative to its largest entry (float32; the port's Jacobians come from
reverse mode, JAX's from forward mode); the Batch state after each update
2e-4 on qpos and 2e-2 on the finite-difference velocity (a 1/h = 100
amplification of the configurations' float32 differences), the cost 1e-2
relative, the same Gauss-Newton iteration count in every update, or one
apart only where the run that went on changed its cost by less than the
1e-8 stopping tolerance in its last iteration (the stopping test compares
a float32 cost difference with 1e-8; the JAX loop's costs are read out by
a debug callback, tests/torch_port_helpers.jax_direct_cost_histories).
"""

import numpy as np
import pytest

from mujoco_mpc_tpu_torch import rollout as TR
from mujoco_mpc_tpu_torch.estimators import batch as tbatch
from mujoco_mpc_tpu_torch.estimators.base import GroundTruth
from mujoco_mpc_tpu_torch.estimators.kalman import Kalman
from mujoco_mpc_tpu_torch.estimators.unscented import Unscented
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.physics import sensors as tsensors
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import (assert_same_stop,
                                      jax_direct_cost_histories,
                                      once_a_session, to_np, tt)

TOL_X, TOL_P = 1e-5, 1e-4
TOL_BATCH_Q, TOL_BATCH_V = 2e-4, 2e-2
BATCH_UPDATES = 5


def _trajectory(pt, n, seed):
  """(states (n, 4), noisy sensors (n, 5), ctrls (n, 1)) of the port's
  own simulation from a swinging start: a sensor read after each step on
  a full forward pass."""
  m = pt.model
  rng = np.random.default_rng(seed)
  fn = tsensors.make_sensor_fn(m)
  d = pt.make_data().replace(qpos=tt([0.1, 2.5]), qvel=tt([0.3, -1.0]))
  states, sensors, ctrls = [], [], []
  for t in range(n):
    u = 0.3 * np.sin(0.05 * t + np.arange(m.nu))
    d = TF.step(m, d.replace(ctrl=tt(u)))
    y = to_np(fn(m, TF.forward(m, d)))
    states.append(to_np(TR.pack_state(d)))
    sensors.append(y + 0.01 * rng.standard_normal(y.shape))
    ctrls.append(u)
  return np.array(states), np.array(sensors), np.array(ctrls)


@pytest.fixture(scope="module")
def cartpole():
  return tregistry.get_task("Cartpole", device="cpu")


def _filter_inputs(pt):
  states, sensors, ctrls = _trajectory(pt, 3, seed=0)
  rng = np.random.default_rng(3)
  x = states[1].astype(np.float32).copy()
  x[:2] += 0.05 * rng.standard_normal(2)
  w = rng.standard_normal((4, 4))
  p = (1e-3 * (w @ w.T / 4 + np.eye(4))).astype(np.float32)
  return dict(x=x, p=p, ctrl=ctrls[2].astype(np.float32),
              y=sensors[2].astype(np.float32))


def _jax_filters(inp):
  import jax.numpy as jnp
  from mujoco_mpc_tpu.estimators.kalman import Kalman as JK
  from mujoco_mpc_tpu.estimators.unscented import Unscented as JU
  from mujoco_mpc_tpu.tasks import registry as jregistry
  jt = jregistry.get_task("Cartpole")
  k, u = JK(jt), JU(jt)
  x, p, c, y = (jnp.asarray(inp[n]) for n in ("x", "p", "ctrl", "y"))
  xm, pm_, innov = k._measure(x, p, k.r_noise, c, y)
  xp, pp = k._predict(x, p, k.q_noise, c)
  xu, pu, _ = u._update(x, p, u.q_noise, u.r_noise, c, y)
  return {n: np.asarray(v) for n, v in dict(
      xm=xm, pm=pm_, innov=innov, xp=xp, pp=pp, xu=xu, pu=pu).items()}


def _close_p(got, want):
  np.testing.assert_allclose(got, want, atol=TOL_P * np.abs(want).max())


def test_ekf_and_ukf_match_jax(cartpole, tmp_path_factory):
  inp = _filter_inputs(cartpole)
  want = once_a_session(tmp_path_factory, "estimators_ekf_ukf",
                        lambda: _jax_filters(inp))
  k = Kalman(cartpole)
  x, p, c, y = (tt(inp[n]) for n in ("x", "p", "ctrl", "y"))
  xm, pm_, innov = k._measure(x, p, k.r_noise, c, y)
  np.testing.assert_allclose(to_np(xm), want["xm"], atol=TOL_X)
  np.testing.assert_allclose(to_np(innov), want["innov"], atol=TOL_X)
  _close_p(to_np(pm_), want["pm"])
  xp, pp = k._predict(x, p, k.q_noise, c)
  np.testing.assert_allclose(to_np(xp), want["xp"], atol=TOL_X)
  _close_p(to_np(pp), want["pp"])
  u = Unscented(cartpole)
  xu, pu, _ = u._update(x, p, u.q_noise, u.r_noise, c, y)
  np.testing.assert_allclose(to_np(xu), want["xu"], atol=TOL_X)
  _close_p(to_np(pu), want["pu"])
  # the public calls: the split update, and the agent's fused step (`step`)
  k.set_state(inp["x"])
  k.p = tt(inp["p"])
  k.update_measurement(inp["ctrl"], inp["y"])
  np.testing.assert_allclose(k.state, want["xm"], atol=TOL_X)
  k.set_state(inp["x"])
  k.p = tt(inp["p"])
  k.update_prediction(inp["ctrl"])
  split = (k.state.copy(), k.covariance.copy())
  k.update_measurement(inp["ctrl"], inp["y"])
  both = (k.state, k.covariance)
  k.set_state(inp["x"])
  k.p = tt(inp["p"])
  k.step(inp["ctrl"], inp["y"])
  np.testing.assert_allclose(split[0], want["xp"], atol=TOL_X)
  np.testing.assert_allclose(k.state, both[0], atol=1e-7)
  np.testing.assert_allclose(k.covariance, both[1], atol=1e-9)


def _jax_batch(states, sensors, ctrls, lengths):
  from mujoco_mpc_tpu.estimators.batch import Batch as JB
  from mujoco_mpc_tpu.tasks import registry as jregistry
  jt = jregistry.get_task("Cartpole")
  out = {}
  for n in lengths:
    est = JB(jt, configuration_length=n)
    est.set_state(states[0])
    rows = []
    with jax_direct_cost_histories() as runs:
      for t in range(1, BATCH_UPDATES + 1):
        est.update(ctrls[t], sensors[t])
        rows.append(np.concatenate([est.state, [est.direct.iterations,
                                                 est.direct.cost]]))
    assert len(runs) == BATCH_UPDATES
    out[f"rows{n}"] = np.array(rows)
    for t, costs in enumerate(runs):
      out[f"costs{n}_{t}"] = np.array(costs)
    out[f"window{n}"] = np.array(est.q_history)
  return out


@pytest.mark.parametrize("length", [3, 32])
def test_batch_matches_jax(cartpole, length, tmp_path_factory):
  states, sensors, ctrls = _trajectory(cartpole, BATCH_UPDATES + 1, seed=1)
  states[0, :2] += np.array([0.05, -0.08])
  want = once_a_session(tmp_path_factory, f"estimators_batch{length}",
                        lambda: _jax_batch(states, sensors, ctrls, (length,)))
  est = tbatch.Batch(cartpole, configuration_length=length)
  assert est.cfg_len == length and est.direct.banded
  est.set_state(states[0])
  nq = cartpole.model.nq
  for t in range(1, BATCH_UPDATES + 1):
    est.update(ctrls[t], sensors[t])
    row = want[f"rows{length}"][t - 1]
    np.testing.assert_allclose(est.state[:nq], row[:nq], atol=TOL_BATCH_Q,
                               err_msg=f"qpos t={t}")
    np.testing.assert_allclose(est.state[nq:4], row[nq:4], atol=TOL_BATCH_V,
                               err_msg=f"qvel t={t}")
    jax_costs = list(want[f"costs{length}_{t - 1}"])
    assert len(jax_costs) == int(row[4]) + 1
    assert len(est.direct.cost_history) == est.direct.iterations + 1
    assert_same_stop(est.direct.cost_history, jax_costs,
                     est.direct.settings.cost_tolerance)
    np.testing.assert_allclose(est.direct.cost, row[5], rtol=1e-2,
                               atol=1e-6)
  np.testing.assert_allclose(np.array(est.q_history),
                             want[f"window{length}"], atol=TOL_BATCH_Q)


def test_batch_refuses_parameter_estimation(cartpole, monkeypatch):
  from mujoco_mpc_tpu_torch.direct import optimizer
  real = optimizer.Direct.__init__

  def with_params(self, *a, **kw):
    real(self, *a, **kw)
    self.nparam = 1
  monkeypatch.setattr(optimizer.Direct, "__init__", with_params)
  with pytest.raises(ValueError, match="parameter estimation"):
    tbatch.Batch(cartpole)


def test_batch_shift_resize_keeps_the_newest_history(cartpole):
  states, sensors, ctrls = _trajectory(cartpole, 6, seed=2)
  est = tbatch.Batch(cartpole, configuration_length=4)
  est.set_state(states[0])
  for t in range(1, 4):
    est.update(ctrls[t], sensors[t])
  newest = est.q_history[-1].copy()
  prior = est.direct.prior_band
  est.shift_resize(6)
  assert est.cfg_len == 6 and len(est.q_history) == 6
  np.testing.assert_allclose(est.q_history[-1], newest)
  np.testing.assert_allclose(est.direct.prior_band[0][-4:], prior[0])
  est.shift_resize(3)
  assert est.cfg_len == 3 and len(est.q_history) == 3
  np.testing.assert_allclose(est.q_history[-1], newest)
  est.update(ctrls[4], sensors[4])
  assert np.isfinite(est.state).all()


def test_batch_recursive_prior_update_conditions_the_window(cartpole):
  """After an update with the recursive prior on, the prior is the
  window's information conditioned on the dropped configuration:
  symmetric, positive semi-definite, no longer scale_prior * I."""
  states, sensors, ctrls = _trajectory(cartpole, 4, seed=4)
  est = tbatch.Batch(cartpole, configuration_length=4,
                     recursive_prior_update=True)
  est.set_state(states[0])
  from mujoco_mpc_tpu_torch.direct.optimizer import band_to_dense
  p0 = band_to_dense(*est.direct.prior_band)
  for t in range(1, 4):
    est.update(ctrls[t], sensors[t])
  p1 = band_to_dense(*est.direct.prior_band)
  assert np.linalg.norm(p1 - p0) > 1e-3
  np.testing.assert_allclose(p1, p1.T, atol=1e-5)
  assert np.all(np.linalg.eigvalsh(p1) > -1e-3)
  assert np.isfinite(est.state).all()


def test_ground_truth_steps_the_model(cartpole):
  """GroundTruth (estimator.h) steps an internal copy of the model with
  the given controls: its state is the pipeline step's."""
  est = GroundTruth(cartpole)
  d = cartpole.make_data()
  for u in (0.5, -0.3):
    est.update(np.array([u]))
    d = TF.step(cartpole.model, d.replace(ctrl=tt([u])))
  np.testing.assert_allclose(est.state, to_np(TR.pack_state(d)), atol=1e-6)
  est.set_state(np.array([0.1, 3.0, 0.0, 0.0]))
  np.testing.assert_allclose(est.state, [0.1, 3.0, 0.0, 0.0], atol=1e-7)
