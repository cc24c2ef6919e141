"""The port's primitive narrowphase (physics/collision.py) against the JAX
package's: each (type1, type2) function on random poses, with touching,
penetrating and parallel cases, and `collide` / `make_contact_frame` on
the plan models of Walker and Humanoid Stand.

Tolerance 1e-5 on (dist, pos, normal): the same float32 formulas, summed
in a different order. The poses are random (no two candidates tie), so the
top-k selections of the box functions pick the same corners on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_mpc_tpu.physics import collision as JC
from mujoco_mpc_tpu.physics import kinematics as JK
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import collision as TC
from mujoco_mpc_tpu_torch.physics import kinematics as TK
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import once_a_session, to_np, tt

TOL = 1e-5
NPAIR = 24


def _rotations(rng, n):
  q = rng.standard_normal((n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
  ], axis=-1).reshape(n, 3, 3)


def _poses(types, seed):
  """(p1, m1, s1, p2, m2, s2) for NPAIR pairs: geom 2 scattered around
  geom 1 so that some pairs are apart and some interpenetrate; the last
  four pairs are special cases (see below)."""
  t1, t2 = types
  rng = np.random.default_rng(seed)
  n = NPAIR
  p1 = rng.uniform(-0.2, 0.2, (n, 3))
  m1 = _rotations(rng, n)
  p2 = p1 + rng.uniform(-0.35, 0.35, (n, 3))
  m2 = _rotations(rng, n)
  s1 = rng.uniform(0.05, 0.2, (n, 3))
  s2 = rng.uniform(0.05, 0.2, (n, 3))
  if t1 == JC.PLANE:
    p2[:, 2] = p1[:, 2] + rng.uniform(-0.1, 0.3, n)
  if t1 == t2 == JC.CAPSULE:
    # parallel axes, side by side and along one line
    m2[-4:-2] = m1[-4:-2]
    p2[-4] = p1[-4] + 0.15 * m1[-4][:, 0]
    p2[-3] = p1[-3] + 0.3 * m1[-3][:, 2]
  if t1 == JC.SPHERE and t2 in (JC.SPHERE, JC.CAPSULE, JC.ELLIPSOID):
    # a touching pair: the centres exactly r1 + r2 apart (on the capsule's
    # centre line where geom 2 is a capsule)
    n_dir = m2[-2][:, 0]
    p2[-2] = p1[-2] + (s1[-2, 0] + s2[-2, 0]) * n_dir
  if t2 == JC.BOX:
    # geom 1 centred deep inside the box
    p1[-1] = p2[-1] + 0.2 * s2[-1] * m2[-1][:, 0]
  return [x.astype(np.float32) for x in (p1, m1, s1, p2, m2, s2)]


@pytest.mark.parametrize("types", sorted(JC._NARROWPHASE),
                         ids=lambda t: "-".join(
                             JC._GEOM_TYPE_NAMES[x] for x in t))
def test_primitive_narrowphase_matches_jax(types):
  assert set(TC.NARROWPHASE) == set(JC._NARROWPHASE)
  args = _poses(types, seed=sum(types) * 7 + types[0])
  want = JC._NARROWPHASE[types](*[jnp.asarray(a) for a in args])
  got = TC.NARROWPHASE[types](*[tt(a) for a in args])
  for name, w, g in zip(("dist", "pos", "normal"), want, got):
    assert tuple(g.shape) == tuple(np.shape(w)), name
    np.testing.assert_allclose(to_np(g), np.asarray(w), atol=TOL, rtol=TOL,
                               err_msg=name)
  dist = np.asarray(want[0])
  assert (dist < 0).any() and (dist > 0).any()   # both regimes covered


@pytest.mark.parametrize("name", ["Walker", "Humanoid Stand"])
def test_collide_and_contact_frame_match_jax_on_plan_models(
    name, tmp_path_factory):
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  jm, pm = jt.plan_model, pt.plan_model
  cp = jm.collision_pairs
  np.testing.assert_array_equal(pm.collision_pairs.con_geom1, cp.con_geom1)
  np.testing.assert_array_equal(pm.collision_pairs.con_geom2, cp.con_geom2)
  rng = np.random.default_rng(3)
  qpos = np.asarray(pt.home_qpos, np.float32).copy()
  free = 7 if name == "Humanoid Stand" else 3
  qpos[free:] += 0.3 * rng.standard_normal(pm.nq - free).astype(np.float32)

  def jax_collide(q):
    d = JK.kinematics(jm, jt.make_data().replace(qpos=q))
    dist, pos, n = JC.collide(jm, d)
    return dist, pos, n, JC.make_contact_frame(n)

  want = once_a_session(
      tmp_path_factory, f"collision_{name}",
      lambda: {str(i): np.asarray(w) for i, w in enumerate(
          jax.jit(jax_collide)(jnp.asarray(qpos)))})
  want = [want[str(i)] for i in range(4)]
  d = TK.kinematics(pm, convert.data_from_numpy(pm, qpos=qpos))
  dist, pos, n = TC.collide(pm, d)
  got = (dist, pos, n, TC.make_contact_frame(n))
  assert dist.shape == (cp.ncon,)
  for what, w, g in zip(("dist", "pos", "normal", "frame"), want, got):
    np.testing.assert_allclose(to_np(g), np.asarray(w), atol=TOL, rtol=TOL,
                               err_msg=what)
  frame = to_np(got[3])
  np.testing.assert_allclose(np.einsum("kij,klj->kil", frame, frame),
                             np.broadcast_to(np.eye(3), frame.shape),
                             atol=1e-5)
