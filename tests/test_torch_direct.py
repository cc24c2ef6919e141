"""The port's Direct optimizer (direct/) against the JAX package's.

  * the block-banded solve (`banded_gn_solve`, even and odd T, with the
    parameter border) and the square-root solve the optimizer takes
    (`srif_gn_solve`) against the JAX functions on the same systems, and
    against a dense numpy solve; JAX eagerly. Tolerance: 2e-3 relative and
    2e-4 absolute, the JAX suite's own for these solves
    (tests/test_direct_banded.py);
  * `Direct.optimize` dense (T=8) and banded (T=24) on a noisy Cartpole
    window against the JAX optimizer (jitted once a session): the same
    status, the same iteration count, or one apart only where the run that
    went on changed its cost by less than the 1e-8 stopping tolerance in
    its last iteration (the stopping test compares a float32 cost
    difference with 1e-8 and can fire a step earlier on one side; the JAX
    loop's costs are read out by a debug callback in its body,
    tests/torch_port_helpers.jax_direct_cost_histories), the port's CPU
    run being the same host-driven loop as on the card, qpos_optimized
    within 2e-3 (float32 Gauss-Newton
    through finite-difference accelerations, cond ~ 1/h^4), the cost
    within 1e-3 relative (T=8 ends at 5.1e-5, where the two float32
    optimisations part by 1e-4 relative), and lower than the initial
    cost;
  * system identification: a pendulum's damping recovered from data
    through the parameter border (tests/test_direct.py's case, on the
    port alone), dense and banded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.direct import banded as jbanded
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.direct import banded as tbanded
from mujoco_mpc_tpu_torch.direct.optimizer import Direct, Status
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.physics import sensors as tsensors
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.test_direct_banded import _random_penta
from tests.torch_port_helpers import (assert_same_stop,
                                      jax_direct_cost_histories,
                                      models_from_xml, once_a_session, to_np,
                                      tt)

RTOL, ATOL = 2e-3, 2e-4
TOL_QPOS = 2e-3


@pytest.mark.parametrize("t_len", [6, 7])
def test_banded_solve_matches_jax_and_dense(t_len):
  rng = np.random.default_rng(t_len)
  b = 3
  h, d1, o1, o2 = _random_penta(rng, t_len, b)
  g = rng.standard_normal((t_len, b))
  dz, dth = tbanded.banded_gn_solve(tt(d1), tt(o1), tt(o2), tt(g))
  assert dth.shape == (0,)
  with jax.disable_jit():
    jdz, _ = jbanded.banded_gn_solve(*(jnp.asarray(x, jnp.float32)
                                       for x in (d1, o1, o2, g)))
  x_ref = np.linalg.solve(h, -g.reshape(-1)).reshape(t_len, b)
  np.testing.assert_allclose(to_np(dz), np.asarray(jdz), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(to_np(dz), x_ref, rtol=RTOL, atol=ATOL)


def test_banded_solve_with_parameter_border():
  rng = np.random.default_rng(1)
  t_len, b, npar = 6, 3, 2
  h, d1, o1, o2 = _random_penta(rng, t_len, b)
  n = t_len * b
  p = 0.2 * rng.standard_normal((t_len, b, npar))
  q = np.eye(npar) * 4.0
  g = rng.standard_normal((t_len, b))
  g_th = rng.standard_normal(npar)
  full = np.zeros((n + npar, n + npar))
  full[:n, :n] = h
  full[:n, n:] = p.reshape(n, npar)
  full[n:, :n] = p.reshape(n, npar).T
  full[n:, n:] = q
  ref = np.linalg.solve(full, -np.concatenate([g.reshape(-1), g_th]))
  args = (d1, o1, o2, g, p, q, g_th)
  dz, dth = tbanded.banded_gn_solve(*map(tt, args))
  with jax.disable_jit():
    jdz, jdth = jbanded.banded_gn_solve(*(jnp.asarray(x, jnp.float32)
                                          for x in args))
  np.testing.assert_allclose(to_np(dz), np.asarray(jdz), rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(to_np(dth), np.asarray(jdth), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(to_np(dz).reshape(-1), ref[:n], rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(to_np(dth), ref[n:], rtol=RTOL, atol=ATOL)


def test_qr_r_factors_the_normal_matrix():
  rng = np.random.default_rng(2)
  for shape in ((9, 5), (4, 7), (6, 6)):
    a = rng.standard_normal(shape)
    r = to_np(tbanded.qr_r(tt(a)))
    assert r.shape == (min(shape), shape[1])
    np.testing.assert_allclose(np.tril(r, -1), 0.0, atol=1e-6)
    if shape[0] >= shape[1]:
      np.testing.assert_allclose(r.T @ r, a.T @ a, atol=1e-4)


@pytest.mark.parametrize("n_p", [0, 2])
def test_srif_solve_matches_jax(n_p):
  """The optimizer's square-root solve: stage rows on three column
  blocks, the matrix prior's square-root rows, Levenberg rows, and an
  optional parameter border, against the JAX function and against the
  dense normal equations."""
  rng = np.random.default_rng(3 + n_p)
  t_len, nr, b = 7, 5, 2
  A, B, C = (rng.standard_normal((t_len - 2, nr, b)) for _ in range(3))
  r = rng.standard_normal((t_len - 2, nr))
  ld = np.stack([np.tril(rng.standard_normal((b, b))) + 2 * np.eye(b)
                 for _ in range(t_len)])
  l1 = 0.3 * rng.standard_normal((t_len - 1, b, b))
  l2 = 0.2 * rng.standard_normal((t_len - 2, b, b))
  rp = rng.standard_normal((t_len, b))
  jth = rng.standard_normal((t_len - 2, nr, n_p)) if n_p else None
  reg = np.float32(1e-3)
  args = [A, B, C, r, ld, l1, l2, rp, reg]
  dz, dth = tbanded.srif_gn_solve(*map(tt, args),
                                  Jth=None if jth is None else tt(jth))
  with jax.disable_jit():
    jdz, jdth = jbanded.srif_gn_solve(
        *(jnp.asarray(x, jnp.float32) for x in args),
        Jth=None if jth is None else jnp.asarray(jth, jnp.float32))
  np.testing.assert_allclose(to_np(dz), np.asarray(jdz), rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(to_np(dth), np.asarray(jdth), rtol=RTOL,
                             atol=ATOL)
  # the dense least-squares normal equations of the same rows
  n = t_len * b + n_p
  rows, rhs = [], []
  for i in range(t_len - 2):
    row = np.zeros((nr, n))
    row[:, i * b:(i + 3) * b] = np.concatenate([A[i], B[i], C[i]], axis=1)
    if n_p:
      row[:, t_len * b:] = jth[i]
    rows.append(row)
    rhs.append(r[i])
  lfull = np.zeros((t_len * b, t_len * b))
  for i in range(t_len):
    lfull[i * b:(i + 1) * b, i * b:(i + 1) * b] = ld[i]
  for k, lk in ((1, l1), (2, l2)):
    for i in range(t_len - k):
      lfull[(i + k) * b:(i + k + 1) * b, i * b:(i + 1) * b] = lk[i]
  prior = np.zeros((t_len * b, n))
  prior[:, :t_len * b] = lfull.T
  rows += [prior, np.sqrt(reg) * np.eye(n)]
  rhs += [rp.reshape(-1), np.zeros(n)]
  jmat, res = np.concatenate(rows), np.concatenate(rhs)
  want = np.linalg.solve(jmat.T @ jmat, -jmat.T @ res)
  np.testing.assert_allclose(to_np(dz).reshape(-1), want[:t_len * b],
                             rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(to_np(dth), want[t_len * b:], rtol=RTOL,
                             atol=ATOL)


def _cartpole_window(horizon, seed=0):
  """(true qpos (T, 2), sensors (T, 5), actuator forces (T, 2), noisy
  initial qpos (T, 2)) of the port's Cartpole from a swinging start."""
  pt = tregistry.get_task("Cartpole", device="cpu")
  m = pt.model
  fn = tsensors.make_sensor_fn(m)
  d = pt.make_data().replace(qpos=tt([0.0, 2.0]))
  qs, ys, fs = [], [], []
  for t in range(horizon):
    d = d.replace(ctrl=tt([0.3 * np.sin(0.2 * t)]))
    df = TF.forward(m, d)
    qs.append(to_np(d.qpos))
    ys.append(to_np(fn(m, df)))
    fs.append(to_np(df.qfrc_actuator))
    d = TF.step(m, d)
  qs = np.array(qs)
  noisy = qs + 0.05 * np.random.default_rng(seed).standard_normal(qs.shape)
  return pt, qs, np.array(ys), np.array(fs), noisy.astype(np.float32)


def _jax_direct(horizon, ys, fs, noisy):
  from mujoco_mpc_tpu.direct.optimizer import Direct as JD
  from mujoco_mpc_tpu.tasks import registry as jregistry
  direct = JD(jregistry.get_task("Cartpole"), horizon)
  for t in range(horizon):
    direct.set_data(t, qpos=noisy[t], sensor=ys[t], force=fs[t])
  direct.set_weights(sensor=1e4, force=1.0)
  with jax_direct_cost_histories() as runs:
    direct.optimize()
  (costs,) = runs
  return dict(qpos=direct.qpos_optimized, cost=np.float64(direct.cost),
              costs=np.array(costs),
              cost0=np.float64(direct.cost_initial),
              it=np.int64(direct.iterations),
              status=np.int64(int(direct.status)),
              banded=np.bool_(direct.banded))


@pytest.mark.parametrize("horizon", [8, 24])
def test_optimize_matches_jax(horizon, tmp_path_factory):
  pt, qs_true, ys, fs, noisy = _cartpole_window(horizon)
  want = once_a_session(tmp_path_factory, f"direct_optimize{horizon}",
                        lambda: _jax_direct(horizon, ys, fs, noisy))
  direct = Direct(pt, horizon)
  assert direct.banded == bool(want["banded"]) == (horizon >= 24)
  for t in range(horizon):
    direct.set_data(t, qpos=noisy[t], sensor=ys[t], force=fs[t])
  direct.set_weights(sensor=1e4, force=1.0)
  direct.optimize()
  assert int(direct.status) == int(want["status"]), (direct.status, want)
  assert len(want["costs"]) == int(want["it"]) + 1
  assert len(direct.cost_history) == direct.iterations + 1
  assert_same_stop(direct.cost_history, list(want["costs"]),
                   direct.settings.cost_tolerance)
  np.testing.assert_allclose(direct.cost_initial, float(want["cost0"]),
                             rtol=1e-4)
  np.testing.assert_allclose(direct.cost, float(want["cost"]), rtol=1e-3)
  np.testing.assert_allclose(direct.qpos_optimized, want["qpos"],
                             atol=TOL_QPOS)
  assert direct.cost < direct.cost_initial
  q_init_err = np.linalg.norm(noisy - qs_true)
  assert np.linalg.norm(direct.qpos_optimized - qs_true) < 0.5 * q_init_err


PENDULUM = """
<mujoco><option timestep="0.01"/>
  <worldbody><body>
    <joint name="j" type="hinge" axis="0 1 0" damping="{damping}"/>
    <geom type="capsule" fromto="0 0 0 0 0 0.4" size="0.02" mass="0.3"/>
  </body></worldbody>
  <sensor><jointpos joint="j"/></sensor>
</mujoco>"""


@pytest.mark.parametrize("horizon", [16, 32])
def test_damping_is_recovered(horizon):
  """System identification (tests/test_direct.py:57): the true pendulum
  has damping 0.25, the model 0.1; theta[0] adds to the model's damping
  and the optimizer recovers it within 0.05 (dense at T=16, banded with
  the Schur border at T=32)."""
  _, true_m, _ = models_from_xml(PENDULUM.format(damping=0.25))
  _, guess_m, _ = models_from_xml(PENDULUM.format(damping=0.1))
  fn = tsensors.make_sensor_fn(true_m)
  d = convert.data_from_numpy(true_m, qpos=[1.2])
  qs, ys = [], []
  for _ in range(horizon):
    qs.append(to_np(d.qpos))
    ys.append(to_np(fn(true_m, TF.forward(true_m, d))))
    d = TF.step(true_m, d)

  def param_update(m, theta):
    return m.replace(dof_damping=m.dof_damping + theta[0])

  direct = Direct(guess_m, horizon, sensor_fn=tsensors.make_sensor_fn(guess_m),
                  param_update=param_update, nparam=1)
  assert direct.banded == (horizon >= 24)
  for t in range(horizon):
    direct.set_data(t, qpos=qs[t], sensor=ys[t], force=np.zeros(1))
  direct.set_weights(sensor=1e4, force=1e2)
  direct.optimize()
  est = 0.1 + float(direct.parameters[0])
  assert abs(est - 0.25) < 0.05, est
  assert direct.status in (Status.SOLVED, Status.MAX_ITERATIONS_FAILURE)


def test_matrix_prior_needs_the_banded_path():
  pt = tregistry.get_task("Cartpole", device="cpu")
  direct = Direct(pt, 6, banded=False)
  direct.prior_band = tuple(np.zeros((n, 2, 2)) for n in (6, 5, 4))
  with pytest.raises(ValueError, match="banded"):
    direct.optimize()
  with pytest.raises(ValueError, match="sensor_fn"):
    Direct(pt.model, 6)
  assert isinstance(direct.sensor_fn(pt.model, TF.forward(
      pt.model, pt.make_data())), torch.Tensor)
