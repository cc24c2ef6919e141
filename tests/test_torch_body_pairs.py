"""Port vs JAX: the rollout kernel's body-body contact pairs (plain
versions, on the CPU) — which pairs and contact points both packages keep,
one step per pair type, pyramidal and elliptic — the Rubik, Cube Solving
and Hand Reorient lane residuals, and the iLQG line search's planning
contacts.

Tolerances: 2e-4 on qpos and 2e-3 on qvel for one step from the same state
(the lane step is discontinuous at solver gates, so every step starts from
the same state), 5e-4 on residual rows. The JAX side runs eagerly
(`jax.disable_jit`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.physics import collision as jcoll
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import (PAIR_GEOMS, models_from_xml,
                                      pair_states, pair_xml, to_np, tt)

TOL_QPOS = 2e-4
TOL_QVEL = 2e-3
TOL_ROWS = 5e-4

PLAN_MODELS = ["Quadruped Flat", "Swimmer", "Cartpole", "Humanoid Stand",
               "Humanoid Track", "Quadrotor", "Walker", "Rubik",
               "Cube Solving", "Hand Reorient"]
# contact points per kept pair: a segment pair, a point in a box, a
# capsule's two ends in a box, a box's 8 corners in the other and back
_POINTS = {(jcoll.SPHERE, jcoll.SPHERE): 1, (jcoll.SPHERE, jcoll.CAPSULE): 1,
           (jcoll.CAPSULE, jcoll.CAPSULE): 1, (jcoll.SPHERE, jcoll.BOX): 1,
           (jcoll.CAPSULE, jcoll.BOX): 2, (jcoll.BOX, jcoll.BOX): 16}
# body contact points of the three hand tasks' planning models (Rubik: its
# whitelist, and everything)
BODY_POINTS = {"Rubik": 156, "Cube Solving": 60, "Hand Reorient": 10}
RUBIK_ALL_BODY_POINTS = 396


def _port_model(jm):
  return convert.model_from_jax_numpy(convert.model_fields(jm), device="cpu")


def _jax_kept_pairs(jm, body_pair_types, contact_geoms):
  """The body pairs the JAX kernel's loop keeps (step_lane.py:1003-1030):
  the six sphere / capsule / box types of the whitelist, ground pairs
  excluded, both geoms planning contacts."""
  ground = {(int(a), int(b)) for g in jstep._ground_groups(jm)
            for a, b in zip(g.geom1, g.geom2)}
  allowed = set(_POINTS) if body_pair_types is None else set(body_pair_types)
  out = []
  for g in jm.collision_pairs.groups:
    types = tuple(int(t) for t in g.types)
    if types not in _POINTS or types not in allowed:
      continue
    for a, b in zip(g.geom1, g.geom2):
      a, b = int(a), int(b)
      if (a, b) in ground:
        continue
      if contact_geoms is not None and not (a in contact_geoms and
                                            b in contact_geoms):
        continue
      out.append((a, b, types))
  return out


@pytest.mark.parametrize("name", PLAN_MODELS)
def test_body_class_and_kept_pairs_match_jax(name):
  """`supports` answers as the JAX package's for every ground_only /
  body_pairs combination; the body pairs and contact points kept with the
  task's planning filters (and with none) are the JAX kernel's."""
  jt = jregistry.get_task(name)
  jm = jt.plan_model
  pm = _port_model(jm)
  for ground_only in (False, True):
    for body_pairs in (False, True):
      assert tstep.supports(pm, ground_only, body_pairs) == jstep.supports(
          jm, ground_only=ground_only, body_pairs=body_pairs), \
          (ground_only, body_pairs)
  c = tstep._static(pm)
  types = getattr(jt, "plan_body_pair_types", None)
  geoms = getattr(jt, "plan_contact_geoms", None)
  for t_, g_ in ((types, geoms), (None, None)):
    want = _jax_kept_pairs(jm, t_, g_)
    got = [(int(g.geom1[pi]), int(g.geom2[pi]), tuple(g.types))
           for g, pi in tstep._selected_body_pairs(pm, t_, g_)]
    assert got == want
    plan = tstep._body_plan(pm, c, t_, g_)
    assert len(plan) == sum(_POINTS[types_] for _, _, types_ in want)
    assert [bc["geoms"] for bc in plan] == [
        (a, b) for a, b, types_ in want for _ in range(_POINTS[types_])]
  if name in BODY_POINTS:
    assert getattr(jt, "plan_body_pairs", False)
    assert len(tstep._body_plan(pm, c, types, geoms)) == BODY_POINTS[name]
  if name == "Rubik":
    assert len(tstep._body_plan(pm, c, None, geoms)) == \
        RUBIK_ALL_BODY_POINTS


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("kind", sorted(PAIR_GEOMS))
def test_body_pair_step_matches_jax(kind, cone):
  """One step of a hinged arm's geom and a free body's geom in contact, at
  five distances (one separated) and, for a point in a box, with the centre
  inside the box: pyramidal condim 3, and elliptic condim 6 at impratio
  10."""
  condim, impratio = (3, 1.0) if cone == "pyramidal" else (6, 10.0)
  jm, pm, _ = models_from_xml(pair_xml(kind, cone, condim, impratio))
  assert not jstep._ground_groups(jm)
  pk = tstep.build_rollout_kernel(pm, 2, 1, body_pairs=True)
  jk = jstep.build_rollout_kernel(jm, 2, 1, interpret=True, body_pairs=True)
  defs = pk.build_defines()
  assert defs["LR_BODY"] == 1 and defs["LR_NCON"] == 0
  assert defs["LR_NBCON"] == (16 if kind == "box_box" else
                              2 if kind == "capsule_box" else 1)
  qpos, qvel = pair_states(kind, pm.nv, np.random.default_rng(41))
  k = qpos.shape[1]
  ctrl = np.zeros((0, k), np.float32)
  with jax.disable_jit():
    jq, jv = jk.step_array(jnp.asarray(qpos, jnp.float32),
                           jnp.asarray(qvel, jnp.float32),
                           jnp.asarray(ctrl), 0)[:2]
  pq, pv = pk.step_array(tt(qpos), tt(qvel), tt(ctrl), 0)
  np.testing.assert_allclose(to_np(pq), np.asarray(jq), atol=TOL_QPOS)
  np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=TOL_QVEL)
  # the lanes pressed in 1 mm or more were pushed back: the free body (dof
  # 3: its z velocity, down at ~0.2 m/s) slowed by far more than the
  # velocity tolerance, unlike the separated lane 0 (gravity and damping)
  dvz = np.asarray(jv)[3] - qvel[3].astype(np.float32)
  assert (dvz[2:] > dvz[0] + 5 * TOL_QVEL).all(), dvz


@pytest.mark.parametrize("kind", sorted(PAIR_GEOMS))
def test_contact_gaps_give_each_pair_depth(kind):
  """`contact_gaps` (the active-row count of chip_smoke.py) of a pair model
  with the arm level and the free body pressed in by each depth of
  `pair_states` (3 mm apart, then 0.5 to 3 mm in; a sphere's centre 5 mm
  inside a box): the deepest of the pair's contact points is -depth, or
  for a sphere off the arm geom's axis the distance along the centres'
  line (the default margin is 0)."""
  _, pm, _ = models_from_xml(pair_xml(kind))
  qpos, _ = pair_states(kind, pm.nv, np.random.default_rng(41))
  qpos[0] = 0.0
  gaps = tstep.contact_gaps(pm, tt(qpos), body_pairs=True)
  assert len(gaps) == (16 if kind == "box_box" else
                       2 if kind == "capsule_box" else 1)
  types = tuple(getattr(tstep, f"GEOM_{name.upper()}")
                for name in kind.split("_"))
  assert all(t == types and condim == 3 for t, condim, _ in gaps)
  want = -np.array([-0.003, 0.0005, 0.001, 0.002, 0.003] + (
      [0.025] if kind == "sphere_box" else []))
  # a free sphere off the arm geom's axis: the gap along the centres' line
  x, y, z = qpos[1], qpos[2], qpos[3] - 0.3
  if kind == "sphere_sphere":
    want = np.sqrt((x - 0.2) ** 2 + y ** 2 + z ** 2) - 0.09
  elif kind == "sphere_capsule":
    want = np.sqrt(y ** 2 + z ** 2) - 0.07
  deepest = np.min([to_np(g) for _, _, g in gaps], axis=0)
  np.testing.assert_allclose(deepest, want, atol=2e-6)


def _hand_states(pt, k, rng):
  """Perturbed home poses of a hand task with the cube moved into the
  first fingertip (1 to 3 mm deep) and random velocities."""
  m = pt.plan_model
  c = tstep._static(m)
  bodies = tstep._body_plan(m, c, getattr(pt, "plan_body_pair_types", None),
                            getattr(pt, "plan_contact_geoms", None))
  home = np.asarray(pt.home_qpos, np.float32)
  bc = next(b for b in bodies if b["kind"] == tstep.BODY_BOX)
  from mujoco_mpc_tpu_torch.physics import kinematics, model as tmodel
  from mujoco_mpc_tpu_torch.ops import lanemath as lm
  d = kinematics.kinematics(m, tmodel.make_data(m).replace(qpos=tt(home)))
  xpos = [tuple(d.xpos[i][a:a + 1] for a in range(3)) for i in range(m.nbody)]
  xquat = [tuple(d.xquat[i][a:a + 1] for a in range(4))
           for i in range(m.nbody)]
  _, dist, nrm = tstep.body_contact_point(
      bc, xpos, xquat, lambda v: lm.const_vec3(v, xpos[0][0]))
  nrm = np.array([float(n_) for n_ in nrm])
  qpos = np.tile(home[:, None], (1, k)).astype(np.float64)
  qa = pt._cube_dadr
  depth = np.linspace(0.001, 0.003, k)
  # geom2 (the cube's box) moves against the normal, toward geom1
  qpos[qa:qa + 3] -= nrm[:, None] * (float(dist) + depth)[None]
  qpos[:pt._nhand] += 0.02 * rng.standard_normal((pt._nhand, k))
  qvel = 0.05 * rng.standard_normal((m.nv, k))
  return qpos.astype(np.float32), qvel.astype(np.float32)


@pytest.mark.parametrize("name", ["Rubik", "Cube Solving", "Hand Reorient"])
def test_hand_task_lane_residual_rows_match_jax(name):
  """The lane residual rows at t = 0 and 2 on moving states; Rubik in Solve
  mode with seeded face goals (the mode gate open)."""
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  assert pspec["dim"] == jspec["dim"] and pspec["naux"] == jspec["naux"]
  assert pspec["dim"] == sum(pt.cost_spec.dims)
  rng = np.random.default_rng(43)
  k = 4
  qpos, qvel = _hand_states(pt, k, rng)
  ctrl = rng.uniform(-0.5, 1.5, (pt.plan_model.nu, k)).astype(np.float32)
  jd0, pd0 = jt.make_data(), pt.make_data()
  # a goal orientation off the identity
  goal = np.array([0.8, 0.3, -0.4, 0.3], np.float32)
  jd0 = jd0.replace(mocap_quat=jnp.asarray(goal[None]))
  pd0 = pd0.replace(mocap_quat=tt(goal[None]))
  jparams = np.asarray(jt.residual_params).copy()
  if name != "Hand Reorient":
    jparams[:6] = rng.uniform(-1.5, 1.5, 6)
    jparams[7], jparams[8] = 3, 2          # MODE_SOLVE, goal index 2
  jaux = np.asarray(jspec["make_aux"](jd0, jnp.asarray(jparams)))
  paux = to_np(pspec["make_aux"](pd0, tt(jparams)))
  np.testing.assert_allclose(paux, jaux, atol=1e-6)
  aux = np.tile(jaux[:, None], (1, k)).astype(np.float32)
  jk = jstep.build_rollout_kernel(
      jt.plan_model, 3, 1, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"], body_pairs=True)
  pk = tstep.build_rollout_kernel(pt.plan_model, 3, 1, residual=pspec,
                                  naux=pspec["naux"], body_pairs=True)
  for t in (0, 2):
    with jax.disable_jit():
      want = np.asarray(jk.residual_array(
          jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl), t,
          jnp.asarray(aux)))
    got = to_np(pk.residual_array(tt(qpos), tt(qvel), tt(ctrl), t, tt(aux)))
    assert got.shape == (jspec["dim"], k)
    np.testing.assert_allclose(got, want, atol=TOL_ROWS, err_msg=f"t={t}")


def test_ilqg_line_search_keeps_every_ground_pair_as_jax():
  """The JAX iLQG builds its lane line search without a contact filter
  (planners/ilqg.py:319-323): every ground pair of the quadruped's plan
  model (8 spheres, 8 capsules, 1 box: 32 points), not the task's 4 feet.
  One step of that build from a pose with a geom other than a foot below
  the floor matches the JAX step."""
  jt = jregistry.get_task("Quadruped Flat")
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  jm, pm = jt.plan_model, pt.plan_model
  spec = pt.lane_residual_spec()
  fb = tilqg._make_lane_feedback(pm, spec, 3)
  kern = fb.kernel
  per_type = {jcoll.SPHERE: 1, jcoll.CAPSULE: 2, jcoll.BOX: 8}
  jax_points = sum(per_type[int(jm.geom_type[b])]
                   for g in jstep._ground_groups(jm) for b in g.geom2)
  assert jax_points == 32
  assert kern.build_defines()["LR_NCON"] == jax_points
  # upside down (a little tilted), lowered until its lowest point is 1 mm
  # in the floor: the trunk's box corners, not a foot
  c = tstep._static(pm)
  plan = tstep._contact_plan(pm, c, None, None)
  q = np.asarray(pt.home_qpos, np.float32).copy()
  q[3:7] = np.array([0.05, 1.0, 0.03, 0.0]) / np.linalg.norm(
      [0.05, 1.0, 0.03, 0.0])
  q[2] -= tstep.contact_clearance(pm, tt(q)) + 0.001
  from mujoco_mpc_tpu_torch.physics import kinematics, model as tmodel
  from mujoco_mpc_tpu_torch.ops.step_lane import _quat_rotate
  d = kinematics.kinematics(pm, tmodel.make_data(pm).replace(qpos=tt(q)))
  xpos, xquat = to_np(d.xpos), to_np(d.xquat)
  below = {con["geom"] for con in plan
           if (xpos[con["bid"]] + _quat_rotate(xquat[con["bid"]],
                                               con["geom_pos"]))[2]
           - con["radius"] < 0.0}
  assert below - set(pt.plan_contact_geoms), below
  k = 3
  rng = np.random.default_rng(47)
  qpos = np.tile(q[:, None], (1, k))
  qvel = (0.1 * rng.standard_normal((pm.nv, k))).astype(np.float32)
  ctrl = rng.uniform(-0.5, 0.5, (pm.nu, k)).astype(np.float32)
  aux = np.tile(to_np(spec["make_aux"](pt.make_data(),
                                       pt.residual_params))[:, None], (1, k))
  jspec = jt.lane_residual_spec()
  jk = jstep.build_rollout_kernel(
      jm, 3, 1, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  with jax.disable_jit():
    jq, jv = jk.step_array(jnp.asarray(qpos), jnp.asarray(qvel),
                           jnp.asarray(ctrl), 0, jnp.asarray(aux))[:2]
  pq, pv = kern.step_array(tt(qpos), tt(qvel), tt(ctrl), 0, tt(aux))[:2]
  np.testing.assert_allclose(to_np(pq), np.asarray(jq), atol=TOL_QPOS)
  np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=TOL_QVEL)
  # the feet-only build the port used before steps elsewhere
  feet_only = tstep.build_rollout_kernel(
      pm, 3, 1, contact_geoms=pt.plan_contact_geoms, residual=spec,
      naux=spec["naux"])
  fv = feet_only.step_array(tt(qpos), tt(qvel), tt(ctrl), 0, tt(aux))[1]
  assert np.abs(to_np(fv) - np.asarray(jv)).max() > 10 * TOL_QVEL
