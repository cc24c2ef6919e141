"""The port's inverse dynamics (physics/inverse.py) against the JAX
package's, from the same (qpos, qvel, qacc): Cartpole (joint limits, RK4
model) and Walker pressed into the floor with active pyramidal contact
rows, where the constraint force at the given acceleration enters. Also
the round trip: the inverse force at forward dynamics' own qacc is the
applied force that produced it.

Tolerances: 1e-4 absolute plus 1e-4 relative on the inverse force against
JAX (the forces reach ~1e3 on Walker's contact rows), 2e-3 relative on the
round trip (float32 through the Newton solve). The JAX side runs eagerly
on Cartpole and jitted once a session on Walker (tests/torch_port_helpers
once_a_session).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_mpc_tpu.physics import inverse as jinverse
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.physics import inverse as tinverse
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import (once_a_session, pressed_state, to_np,
                                      tt)

ATOL, RTOL = 1e-4, 1e-4
TOL_ROUND_TRIP = 2e-3


def _cases(pt, n, seed):
  rng = np.random.default_rng(seed)
  m = pt.model
  out = []
  for i in range(n):
    if pt.name == "Walker":
      qpos, qvel, _ = pressed_state(pt, seed + i, depth=0.004)
    else:
      qpos = rng.uniform(-1, 1, m.nq).astype(np.float32)
      lim = float(to_np(m.jnt_range)[0, 1])
      qpos[0] = np.sign(qpos[0]) * (lim + 0.01)   # past a slider limit
      qvel = rng.standard_normal(m.nv).astype(np.float32)
    qacc = (3 * rng.standard_normal(m.nv)).astype(np.float32)
    out.append((qpos, qvel, qacc))
  return out


def _jax_inverse(jt, cases, jit):
  m = jt.model

  def inv(qpos, qvel, qacc):
    d = jt.make_data().replace(qpos=qpos, qvel=qvel)
    return jinverse.inverse(m, d, qacc)

  if jit:
    fn = jax.jit(inv)
    return np.stack([np.asarray(fn(*map(jnp.asarray, c))) for c in cases])
  with jax.disable_jit():
    return np.stack([np.asarray(inv(*map(jnp.asarray, c))) for c in cases])


@pytest.mark.parametrize("name", ["Cartpole", "Walker"])
def test_inverse_matches_jax(name, tmp_path_factory):
  pt = tregistry.get_task(name, device="cpu")
  cases = _cases(pt, 3, seed=11)
  if name == "Walker":
    want = once_a_session(
        tmp_path_factory, "inverse_walker",
        lambda: {"f": _jax_inverse(jregistry.get_task(name), cases,
                                   jit=True)})["f"]
  else:
    want = _jax_inverse(jregistry.get_task(name), cases, jit=False)
  m = pt.model
  active = 0
  for (qpos, qvel, qacc), w in zip(cases, want):
    d = convert.data_from_numpy(m, qpos=qpos, qvel=qvel)
    got = to_np(tinverse.inverse(m, d, tt(qacc)))
    np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL)
    di = tinverse.inv_stages(m, d)
    active += int((to_np(di.efc_D) > 0).sum())
    # without the constraint force: M a + bias - passive
    smooth = to_np(tinverse.inverse(m, d, tt(qacc), smooth_only=True))
    assert smooth.shape == got.shape
  assert active > 0, "no constraint row was active"


@pytest.mark.parametrize("name", ["Cartpole", "Walker"])
def test_inverse_of_forward_acceleration_is_the_applied_force(name):
  """forward at (q, v, ctrl) gives qacc; the inverse at that qacc gives
  back qfrc_actuator + qfrc_applied: the soft constraint force is the
  same explicit function of qacc on both sides."""
  pt = tregistry.get_task(name, device="cpu")
  m = pt.model
  rng = np.random.default_rng(5)
  for qpos, qvel, _ in _cases(pt, 2, seed=21):
    ctrl = rng.uniform(-1, 1, m.nu).astype(np.float32)
    applied = (0.5 * rng.standard_normal(m.nv)).astype(np.float32)
    d = convert.data_from_numpy(m, qpos=qpos, qvel=qvel, ctrl=ctrl,
                                qfrc_applied=applied)
    fwd = TF.forward(m, d)
    want = to_np(fwd.qfrc_actuator) + applied
    got = to_np(tinverse.inverse(m, d, fwd.qacc))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL_ROUND_TRIP * scale)
