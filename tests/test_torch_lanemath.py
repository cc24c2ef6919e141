"""Port vs JAX: component math of ops/lanemath.py (tolerance 1e-5: both
are float32 and differ only in operation order inside the libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_mpc_tpu.ops import lanemath as jlm
from mujoco_mpc_tpu_torch.ops import lanemath as tlm
from tests.torch_port_helpers import to_np, tt

TOL = 1e-5
K = 16


def _tuples(rng, n):
  a = rng.standard_normal((n, K)).astype(np.float32)
  return a, tuple(jnp.asarray(r) for r in a), tuple(tt(r) for r in a)


@pytest.mark.parametrize("name,na,nb", [
    ("vadd", 3, 3), ("vsub", 3, 3), ("vcross", 3, 3), ("qmul", 4, 4),
    ("qrot", 4, 3)])
def test_binary_tuple_ops_match_jax(name, na, nb):
  rng = np.random.default_rng(0)
  _, ja, ta = _tuples(rng, na)
  _, jb, tb = _tuples(rng, nb)
  want = np.stack([np.asarray(r) for r in getattr(jlm, name)(ja, jb)])
  got = np.stack([to_np(r) for r in getattr(tlm, name)(ta, tb)])
  np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_vdot_vscale_axis_angle_const_match_jax():
  rng = np.random.default_rng(1)
  a, ja, ta = _tuples(rng, 3)
  b, jb, tb = _tuples(rng, 3)
  s = rng.standard_normal(K).astype(np.float32)
  np.testing.assert_allclose(to_np(tlm.vdot(ta, tb)),
                             np.asarray(jlm.vdot(ja, jb)), atol=TOL)
  np.testing.assert_allclose(
      np.stack([to_np(r) for r in tlm.vscale(ta, tt(s))]),
      np.stack([np.asarray(r) for r in jlm.vscale(ja, jnp.asarray(s))]),
      atol=TOL)
  np.testing.assert_allclose(
      np.stack([to_np(r) for r in tlm.axis_angle_quat(ta, tt(s))]),
      np.stack([np.asarray(r) for r in
                jlm.axis_angle_quat(ja, jnp.asarray(s))]), atol=TOL)
  np.testing.assert_allclose(
      np.stack([to_np(r) for r in tlm.const_vec3([1, -2, 3], tt(s))]),
      np.stack([np.asarray(r) for r in
                jlm.const_vec3([1, -2, 3], jnp.asarray(s))]), atol=0)


@pytest.mark.parametrize("n", [1, 3, 6, 18])
def test_chol_solve_packed_matches_jax(n):
  rng = np.random.default_rng(n)
  l = rng.standard_normal((K, n, n)).astype(np.float32)
  a = np.einsum("kij,klj->kil", l, l) + 0.5 * np.eye(n, dtype=np.float32)
  a = np.ascontiguousarray(np.moveaxis(a, 0, -1))      # (n, n, K)
  b = rng.standard_normal((n, K)).astype(np.float32)
  want = np.asarray(jlm.chol_solve_packed(jnp.asarray(a), jnp.asarray(b)))
  got = to_np(tlm.chol_solve_packed(tt(a), tt(b)))
  scale = np.abs(want).max()
  np.testing.assert_allclose(got, want, atol=TOL * max(scale, 1.0))
  # and it solves the system
  np.testing.assert_allclose(np.einsum("ijk,jk->ik", a, got), b,
                             atol=2e-3 * max(scale, 1.0))


def test_chol_solve_packed_clamps_indefinite_diagonal():
  """A non-positive pivot is clamped (1e-10) instead of producing NaN, in
  both packages alike."""
  a = np.zeros((2, 2, 3), np.float32)
  a[0, 0], a[1, 1] = 1.0, -1.0
  b = np.ones((2, 3), np.float32)
  want = np.asarray(jlm.chol_solve_packed(jnp.asarray(a), jnp.asarray(b)))
  got = to_np(tlm.chol_solve_packed(tt(a), tt(b)))
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, want, rtol=1e-5)
