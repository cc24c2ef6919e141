"""Port vs JAX: the batched Cholesky solve (B4, ops/cholesky.py).

On CPU tensors the port's kernel wrapper runs its plain version; the JAX
side is `mujoco_mpc_tpu/ops/cholesky.py:chol_solve_lanes` with its Pallas
kernel in interpret mode, evaluated eagerly (`jax.disable_jit`: the same
sizes as tests/test_ops.py, which compiles them; here nothing is compiled).
Tolerance: 2e-3, the JAX suite's bar. The port multiplies by each pivot's
reciprocal where the Pallas kernel divides (ops/cholesky.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import cholesky as jcholesky
from mujoco_mpc_tpu_torch.ops import cholesky as tcholesky
from mujoco_mpc_tpu_torch.physics import forward as tforward
from mujoco_mpc_tpu_torch.physics import smooth as tsmooth
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np

TOL = 2e-3


def _spd(n, k, seed):
  rng = np.random.default_rng(seed)
  g = rng.standard_normal((k, n, n))
  a = np.einsum("kij,klj->kil", g, g) + n * np.eye(n)[None]
  b = rng.standard_normal((k, n))
  return a.astype(np.float32), b.astype(np.float32)   # (K, n, n), (K, n)


@pytest.mark.parametrize("n,k", [(4, 128), (18, 128), (7, 256)])
def test_plain_version_matches_jax_chol_solve_lanes(n, k):
  a, b = _spd(n, k, seed=n)
  a_lane = np.ascontiguousarray(np.moveaxis(a, 0, -1))   # (n, n, K)
  b_lane = np.ascontiguousarray(b.T)                     # (n, K)
  with jax.disable_jit():
    want = np.asarray(jcholesky.chol_solve_lanes(
        jnp.asarray(a_lane), jnp.asarray(b_lane), interpret=True))
  got = to_np(tcholesky.chol_solve_lanes(torch.as_tensor(a_lane),
                                         torch.as_tensor(b_lane)))
  assert got.shape == (n, k)
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_version_clamps_the_diagonal():
  """An indefinite matrix gives a finite answer (diagonal clamped at
  1e-10), as the Pallas kernel's clamp does."""
  a = torch.tensor([[[1.0], [2.0]], [[2.0], [1.0]]])   # eigenvalues 3, -1
  x = tcholesky.chol_solve_lanes(a, torch.tensor([[1.0], [1.0]]))
  assert torch.isfinite(x).all()


def test_vmap_rule_equals_plain_version():
  """spd_solve under torch.func.vmap (one batch, two nested batches, one
  operand unbatched) against the plain version on the lane layout."""
  a, b = _spd(6, 10, seed=1)
  ta, tb = torch.as_tensor(a), torch.as_tensor(b)
  want = tcholesky.chol_solve_lanes_plain(ta.permute(1, 2, 0), tb.T).T
  got = torch.func.vmap(tcholesky.spd_solve)(ta, tb)
  torch.testing.assert_close(got, want, atol=0, rtol=0)
  nested = torch.func.vmap(torch.func.vmap(tcholesky.spd_solve))(
      ta.reshape(2, 5, 6, 6), tb.reshape(2, 5, 6))
  torch.testing.assert_close(nested.reshape(10, 6), want, atol=0, rtol=0)
  one_a = torch.func.vmap(tcholesky.spd_solve, in_dims=(None, 0))(ta[3], tb)
  want_a = tcholesky.chol_solve_lanes_plain(
      ta[3][..., None].expand(6, 6, 10), tb.T).T
  torch.testing.assert_close(one_a, want_a, atol=0, rtol=0)
  np.testing.assert_allclose(
      to_np(got), np.linalg.solve(a, b[..., None])[..., 0], atol=1e-5)


def test_kernel_route_of_the_pipeline_physics_matches_library_route():
  """A Swimmer step with every SPD solve through the batched Cholesky
  kernel's route (its plain version here) against the library route."""
  task = tregistry.get_task("Swimmer", device="cpu")
  m = task.plan_model
  rng = np.random.default_rng(2)
  d = task.make_data()
  d = d.replace(qpos=d.qpos + torch.as_tensor(
      0.3 * rng.standard_normal(m.nq).astype(np.float32)),
      qvel=torch.as_tensor(rng.standard_normal(m.nv).astype(np.float32)),
      ctrl=torch.as_tensor(rng.uniform(-1, 1, m.nu).astype(np.float32)))
  mk = m.replace(solve_route=tsmooth.SOLVE_KERNEL)
  lib, ker = tforward.step(m, d), tforward.step(mk, d)
  assert ker.qLD is None and lib.qLD is not None
  # the two factorisations round differently; qacc reaches ~1e3 here, so
  # each field is held to 1e-5 of its largest entry
  for f in ("qpos", "qvel", "qacc"):
    want = getattr(lib, f)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(getattr(ker, f), want, atol=1e-5 * scale,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1, 37), (8, 16), (18, 4096), (32, 37)])
def test_cuda_kernel_matches_plain_on_the_card(n, k):
  """Needs the card: the batched Cholesky kernel against its plain version
  at the gate's ends, the robust path's shape and the time's shape, K not a
  multiple of the systems a block where it can be (the full comparison is
  chip_smoke.py; run this with `pytest -m cuda`)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  a, b = _spd(n, k, seed=n)
  a_lane = torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1))).cuda()
  b_lane = torch.as_tensor(np.ascontiguousarray(b.T)).cuda()
  before = tcholesky.launch_count
  x = tcholesky.chol_solve_lanes(a_lane, b_lane)
  assert tcholesky.launch_count == before + 1
  want = tcholesky.chol_solve_lanes_plain(a_lane, b_lane)
  torch.testing.assert_close(x, want, atol=TOL, rtol=TOL)
