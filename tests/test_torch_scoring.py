"""Port vs JAX: the fused scoring kernel (B3, ops/scoring.py).

The port's kernel takes residuals (T, nr, K); on CPU tensors it runs its
plain version (the mean over the horizon of CostSpec.cost). The JAX side
is `mujoco_mpc_tpu/ops/scoring.py:score_fused` with its Pallas kernel in
interpret mode, as tests/test_ops.py runs it (at other shapes, so the two
files compile different computations). Tolerance: 2e-4 absolute and
relative, the JAX suite's bar for its kernel against its reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import scoring as jscoring
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.ops import scoring as tscoring
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

TOL = 2e-4
TASKS = ["Quadruped Flat", "Swimmer", "Cartpole"]


def _specs(name):
  return (jregistry.get_task(name).cost_spec,
          tregistry.get_task(name, device="cpu").cost_spec)


def _residuals(nr, seed, k=6, t=5):
  rng = np.random.default_rng(seed)
  return rng.standard_normal((k, t, nr)).astype(np.float32)


@pytest.mark.parametrize("name", TASKS)
def test_plain_version_matches_jax_score_fused(name):
  jspec, pspec = _specs(name)
  res = _residuals(pspec.num_residual, seed=len(name))
  want = np.asarray(jscoring.score_fused(jnp.asarray(res), jspec,
                                         interpret=True))
  scorer = tscoring.make_scorer(pspec, "cpu")
  assert scorer.route == "kernel" and scorer.gate is None
  got = to_np(scorer(tt(res).permute(1, 2, 0)))
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_call_time_weights_reach_the_returns():
  jspec, pspec = _specs("Swimmer")
  jspec = jspec.set_weight(jspec.term_names[1], 3.5)
  pspec2 = pspec.set_weight(pspec.term_names[1], 3.5)
  res = _residuals(pspec.num_residual, seed=3)
  want = np.asarray(jscoring.score_fused(jnp.asarray(res), jspec,
                                         interpret=True))
  got = to_np(tscoring.make_scorer(pspec, "cpu")(
      tt(res).permute(1, 2, 0), pspec2))
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["risk", "norm"])
def test_gate_takes_the_plain_cost_as_jax_does(case):
  """risk != 0 or a norm the kernel does not compute: the JAX function
  takes its jnp cost; the port's scorer takes the plain cost on the CPU,
  records the route and its reason, and on a CUDA device raises naming the
  gate."""
  jspec, pspec = _specs("Cartpole")
  if case == "risk":
    jspec = jspec.replace(risk=jnp.asarray(0.3, jnp.float32))
    pspec = pspec.replace(risk=torch.tensor(0.3))
  else:   # COSH on the first term
    types = (3,) + tuple(pspec.norm_types[1:])
    jspec = jspec.replace(norm_types=types)
    pspec = pspec.replace(norm_types=types)
  res = _residuals(pspec.num_residual, seed=4)
  want = np.asarray(jscoring.score_fused(jnp.asarray(res), jspec))
  np.testing.assert_allclose(
      want, np.asarray(jscoring.score_reference(jnp.asarray(res), jspec)))
  scorer = tscoring.make_scorer(pspec, "cpu")
  assert scorer.route == "plain"
  assert ("risk" if case == "risk" else "COSH") in scorer.gate
  got = to_np(scorer(tt(res).permute(1, 2, 0)))
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
  with pytest.raises(NotImplementedError, match="fused scoring kernel"):
    tscoring.make_scorer(pspec, "cuda")


def test_build_defines_carry_the_term_structure():
  _, pspec = _specs("Quadruped Flat")
  d = tscoring.build_defines(pspec)
  assert d["SF_NTERM"] == pspec.num_term == 9
  assert d["SF_NR"] == pspec.num_residual == 42
  offs = np.cumsum((0,) + tuple(pspec.dims[:-1]))
  for i in range(pspec.num_term):
    assert (d[f"SF_TYPE_{i}"], d[f"SF_OFF_{i}"], d[f"SF_DIM_{i}"]) == (
        pspec.norm_types[i], offs[i], pspec.dims[i])
  # nvcc splits a -D value at commas: every value is one number
  assert all("," not in str(v) for v in d.values())
