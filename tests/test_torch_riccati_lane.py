"""The port's iLQG backward sweep against the JAX package's.

`planners.ilqg.backward_pass` of the port (a Python loop of torch ops, the
plain version of the CUDA Riccati kernel) gets the same numpy-seeded
problem as the JAX `backward_pass` (the XLA scan) and as the Pallas kernel
`ops/riccati_lane.py` in interpret mode. Tolerance: 1e-4 abs / 1e-3 rel
(2e-4 abs at ndx >= 36), the JAX suite's own bars for kernel vs scan: the
three differ in summation order only, on problems whose box-QP decisions
have margins. The CUDA source's own arithmetic is held against the plain
version in tests/test_torch_kernel_source.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import riccati_lane as jax_riccati
from mujoco_mpc_tpu.planners import ilqg as jax_ilqg
from mujoco_mpc_tpu_torch.ops import riccati_lane as t_riccati
from mujoco_mpc_tpu_torch.planners import ilqg as t_ilqg
from tests.torch_port_helpers import riccati_problem, tt


def _both(prob, reg, iters, reg_type):
  ref = jax_ilqg.backward_pass(*[jnp.asarray(x) for x in prob],
                               jnp.float32(reg), iters, reg_type)
  got = t_ilqg.backward_pass(*[tt(x) for x in prob], tt(reg), iters,
                             reg_type)
  return ref, got


def _assert_close(got, ref, atol, dv2=True):
  ks, km, dv, ok = got
  ks_ref, km_ref, dv_ref, ok_ref = ref
  assert tuple(ks.shape) == ks_ref.shape and tuple(km.shape) == km_ref.shape
  np.testing.assert_allclose(ks.numpy(), np.asarray(ks_ref), atol=atol,
                             rtol=1e-3)
  np.testing.assert_allclose(km.numpy(), np.asarray(km_ref), atol=atol,
                             rtol=1e-3)
  for i in range(2 if dv2 else 1):
    np.testing.assert_allclose(float(dv[i]), float(dv_ref[i]), atol=atol,
                               rtol=1e-3)
  assert bool(ok) == bool(ok_ref)


@pytest.mark.parametrize("reg_type", [0, 1, 2, 3])
@pytest.mark.parametrize("tight_limits", [False, True])
@pytest.mark.parametrize("ndx,nu,horizon", [(4, 1, 8), (16, 5, 12)])
def test_backward_pass_matches_jax_scan(ndx, nu, horizon, tight_limits,
                                        reg_type):
  prob = riccati_problem(horizon, ndx, nu, seed=reg_type * 2 + tight_limits,
                         tight_limits=tight_limits)
  ref, got = _both(prob, 1e-2, 6, reg_type)
  _assert_close(got, ref, 1e-4)


@pytest.mark.parametrize("reg_type", [0, 1, 2, 3])
@pytest.mark.parametrize("tight_limits", [False, True])
@pytest.mark.parametrize("ndx,nu,horizon", [(4, 1, 8), (16, 5, 10)])
def test_backward_pass_matches_pallas_interpret(ndx, nu, horizon,
                                                tight_limits, reg_type):
  prob = riccati_problem(horizon, ndx, nu, seed=11 + reg_type * 2 +
                         tight_limits, tight_limits=tight_limits)
  kern = jax_riccati.build_backward_kernel(ndx, nu, horizon, 6, reg_type,
                                           interpret=True)
  ref = kern(*[jnp.asarray(x) for x in prob], jnp.float32(1e-2))
  got = t_ilqg.backward_pass(*[tt(x) for x in prob], tt(1e-2), 6, reg_type)
  _assert_close(got, ref, 1e-4)


def test_backward_pass_robot_size():
  """Quadruped-class shape (ndx 36, nu 12), tight limits."""
  prob = riccati_problem(5, 36, 12, seed=7 * 36 + 12, tight_limits=True)
  ref, got = _both(prob, 1e-2, 4, 0)
  _assert_close(got, ref, 2e-4, dv2=False)


def test_clamping_fires():
  """With tight limits some k entries sit exactly on the bounds and the
  corresponding K rows are zero (free-set semantics), in the port as in the
  JAX package."""
  prob = riccati_problem(6, 7, 3, seed=99, tight_limits=True)
  ks, km, _, ok = t_ilqg.backward_pass(*[tt(x) for x in prob], tt(1e-2), 6,
                                       0)
  assert bool(ok)
  ks, km = ks.numpy(), km.numpy()
  on_bound = np.isclose(np.abs(ks), 0.05, atol=1e-6)
  assert on_bound.any(), "expected clamped actions with tight limits"
  assert np.allclose(km[on_bound], 0.0, atol=1e-6)
  ref = jax_ilqg.backward_pass(*[jnp.asarray(x) for x in prob],
                               jnp.float32(1e-2), 6, 0)
  np.testing.assert_array_equal(
      on_bound, np.isclose(np.abs(np.asarray(ref[0])), 0.05, atol=1e-6))


def test_wrapper_takes_plain_version_on_cpu_and_keeps_the_gate():
  assert t_riccati.supports(16, 5, 40)
  assert t_riccati.supports(128, 32, 512)
  assert not t_riccati.supports(129, 5, 40)
  assert not t_riccati.supports(16, 33, 40)
  assert not t_riccati.supports(16, 5, 513)
  with pytest.raises(ValueError):
    t_riccati.build_backward_kernel(130, 5, 40, 6, 0)
  prob = [tt(x) for x in riccati_problem(8, 4, 1, seed=3,
                                         tight_limits=True)]
  kern = t_riccati.build_backward_kernel(4, 1, 8, 6, 0)
  before = t_riccati.launch_count
  ks, km, dv, ok = kern(*prob, tt(1e-2))
  want = t_ilqg.backward_pass(*prob, tt(1e-2), 6, 0)
  assert t_riccati.launch_count == before      # nothing launched on the CPU
  torch.testing.assert_close(ks, want[0])
  torch.testing.assert_close(km, want[1])
  assert kern.workspace_floats == t_riccati.workspace_floats(4, 1)


def test_regularization_schedule_matches_jax():
  rng = np.random.default_rng(0)
  for _ in range(40):
    reg, rate = 10.0 ** rng.uniform(-6, 5), 10.0 ** rng.uniform(-2, 2)
    z, s = rng.uniform(-0.2, 2.2), 10.0 ** rng.uniform(-3, 0)
    if rng.uniform() < 0.1:
      z = np.nan
    ref = jax_ilqg.update_regularization(
        jnp.float32(reg), jnp.float32(rate), 10.0, 1e-6, 1e6,
        jnp.float32(z), jnp.float32(s))
    got = t_ilqg.update_regularization(tt(reg), tt(rate), 10.0, 1e-6, 1e6,
                                       tt(z), tt(s))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_card():
  """Needs the card: the Riccati kernel against `backward_pass` (the full
  comparison is chip_smoke.py; run this with `pytest -m cuda`)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  prob = [tt(x).cuda() for x in riccati_problem(12, 16, 5, seed=1,
                                                tight_limits=False)]
  kern = t_riccati.build_backward_kernel(16, 5, 12, 6, 0)
  before = t_riccati.launch_count
  ks, km, dv, ok = kern(*prob, tt(1e-2).cuda())
  assert t_riccati.launch_count == before + 1
  want = kern.plain(*prob, tt(1e-2).cuda())
  torch.testing.assert_close(ks, want[0], atol=1e-4, rtol=1e-3)
  torch.testing.assert_close(km, want[1], atol=1e-4, rtol=1e-3)
  assert bool(ok) and bool(want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("reg_type", [0, 1, 2, 3])
@pytest.mark.parametrize("ndx,nu,horizon,tight_limits",
                         [(16, 5, 40, True), (36, 12, 40, False),
                          (128, 32, 40, False)])
def test_cuda_kernel_matches_plain_at_each_size_on_the_card(
    ndx, nu, horizon, tight_limits, reg_type):
  """Needs the card: the Riccati kernel against `backward_pass` at Swimmer's
  size with limits that clamp (compared on the steps before the first
  free-set flip, as chip_smoke.py does), a quadruped's and the gate's
  largest size, every regularisation type."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  prob = [tt(x).cuda() for x in riccati_problem(
      horizon, ndx, nu, seed=ndx + reg_type, tight_limits=tight_limits)]
  kern = t_riccati.build_backward_kernel(ndx, nu, horizon, 6, reg_type)
  assert kern.layout["workspace_in_shared_memory"]
  ks, km, dv, ok = kern(*prob, tt(1e-2).cuda())
  want = kern.plain(*prob, tt(1e-2).cuda())
  lo, hi = prob[7], prob[8]
  clamped = lambda k: (k <= lo) | (k >= hi)
  flips = torch.nonzero((clamped(ks) != clamped(want[0])).any(dim=1))
  sel = slice(int(flips.max()) + 1 if len(flips) else 0, None)
  atol = 1e-4 if ndx < 36 else 2e-4
  torch.testing.assert_close(ks[sel], want[0][sel], atol=atol, rtol=1e-3)
  torch.testing.assert_close(km[sel], want[1][sel], atol=atol, rtol=1e-3)
  assert bool(ok) and bool(want[3])
