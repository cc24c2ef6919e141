"""Port vs JAX: the rollout kernel's capsule and box ground contacts, site
transmissions and per-step aux rows (plain versions, on the CPU), the
ground-pair class both packages keep, and the humanoid / tracking /
quadrotor lane residuals.

Tolerances: 2e-4 on qpos and 2e-3 on qvel for one step from the same state
(the lane step is discontinuous at solver gates, so every step starts from
the JAX state), 5e-4 on residual rows, 1e-6 on the tracking clip and its
aux rows, 1e-4 relative on returns. The JAX side runs eagerly
(`jax.disable_jit`): compiling a humanoid step for the CPU takes minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu.tasks import tracking as jtracking
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import sampling_lane as tsampling_lane
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics import model as tmodel
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.spline import Interpolation
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from mujoco_mpc_tpu_torch.tasks import tracking as ttracking
from tests.torch_port_helpers import (DROP, DROP_GEOMS, clearances,
                                      models_from_xml, once_a_session, to_np,
                                      tt)

TOL_QPOS = 2e-4
TOL_QVEL = 2e-3
TOL_ROWS = 5e-4
TOL_CLIP = 1e-6
TOL_RETURN_REL = 1e-4

PLAN_MODELS = ["Quadruped Flat", "Swimmer", "Cartpole", "Humanoid Stand",
               "Humanoid Track", "Quadrotor", "Walker"]

def _jax_plan_model(name):
  return jregistry.get_task(name).plan_model


def _port_model(jm):
  return convert.model_from_jax_numpy(convert.model_fields(jm), device="cpu")


@pytest.mark.parametrize("name", PLAN_MODELS)
def test_ground_class_and_kept_pairs_match_jax(name):
  """Both packages keep the same plane-vs-{sphere, capsule, box} pairs
  (other geom types, e.g. the quadrotor's cylinders, are dropped), answer
  `supports` alike, and the gate's text names only what is unported."""
  jm = _jax_plan_model(name)
  pm = _port_model(jm)
  assert tstep.supports(pm, ground_only=True) == jstep.supports(
      jm, ground_only=True, body_pairs=False)
  assert tstep.supports(pm) == jstep.supports(jm)
  jpairs = [(int(a), int(b)) for g in jstep._ground_groups(jm)
            for a, b in zip(g.geom1, g.geom2)]
  ppairs = [(int(g.geom1[pi]), int(g.geom2[pi]))
            for g, pi in tstep._selected_ground_pairs(pm, None, None)]
  assert ppairs == jpairs
  # one contact point per sphere, two per capsule, eight per box
  per_type = {2: 1, 3: 2, 6: 8}
  c = tstep._static(pm)
  plan = tstep._contact_plan(pm, c, None, None)
  assert len(plan) == sum(per_type[int(jm.geom_type[b])] for _, b in jpairs)
  if name.startswith("Humanoid"):
    assert len(plan) == 39      # 1 sphere, 11 capsules, 2 boxes
  lossy = pm.replace(dof_frictionloss=torch.full((pm.nv,), 0.1))
  with pytest.raises(NotImplementedError) as err:
    tstep.build_rollout_kernel(lossy, 4, 1)
  msg = str(err.value)
  assert "friction loss" in msg and "ball joints" in msg
  assert "site" not in msg and "capsule" not in msg and "aux" not in msg
  assert "body-body" not in msg


def test_quadruped_feet_filters_keep_the_four_feet():
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  m = pt.plan_model
  c = tstep._static(m)
  feet_bodies = sorted(int(m.geom_bodyid[g]) for g in pt.plan_contact_geoms)
  for kw in (dict(contact_types=None, contact_geoms=pt.plan_contact_geoms),
             dict(contact_types=(GEOM_SPHERE,),
                  contact_geoms=pt.plan_contact_geoms)):
    plan = tstep._contact_plan(m, c, **kw)
    assert sorted(con["bid"] for con in plan) == feet_bodies, kw
    assert all(con["radius"] > 0 for con in plan)
  # spheres only: the feet and the four knees; everything: + 8 capsules'
  # 16 ends + the trunk box's 8 corners
  assert len(tstep._contact_plan(m, c, (GEOM_SPHERE,), None)) == 8
  assert len(tstep._contact_plan(m, c, None, None)) == 8 + 16 + 8


def _steps_from_jax_state(jm, pm, qpos, qvel, ctrl, steps):
  """`steps` steps in each package, every port step from the JAX state;
  returns the per-step (qpos, qvel) max errors and the last JAX state."""
  jk = jstep.build_rollout_kernel(jm, 2, 1, interpret=True)
  pk = tstep.build_rollout_kernel(pm, 2, 1)
  jq, jv = jnp.asarray(qpos), jnp.asarray(qvel)
  errs = []
  with jax.disable_jit():
    for t in range(steps):
      pq, pv = pk.step_array(tt(np.array(jq)), tt(np.array(jv)), tt(ctrl), t)
      jq, jv = jk.step_array(jq, jv, jnp.asarray(ctrl), t)[:2]
      errs.append((float(np.abs(to_np(pq) - np.asarray(jq)).max()),
                   float(np.abs(to_np(pv) - np.asarray(jv)).max())))
  return errs, np.asarray(jq), np.asarray(jv)


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("kind", ["capsule", "box"])
def test_capsule_and_box_ground_steps_match_jax(kind, cone):
  """A free capsule (two end points) and a free box (eight corners), tilted,
  pressed into the floor by 0.5 to 3 mm, sliding and spinning."""
  jm, pm, mjm = models_from_xml(DROP.format(cone=cone,
                                            geom=DROP_GEOMS[kind]))
  assert tstep.supports(pm, ground_only=True)
  k = 4
  rng = np.random.default_rng(11)
  qpos = np.tile(mjm.qpos0[:, None], (1, k)).astype(np.float32)
  qpos[3:7] += 0.3 * rng.standard_normal((4, k)).astype(np.float32)
  qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
  qpos[2] -= clearances(pm, qpos) + np.array([0.0005, 0.001, 0.002, 0.003])
  qvel = (0.3 * rng.standard_normal((6, k))).astype(np.float32)
  qvel[2] = -0.2
  errs, _, jv = _steps_from_jax_state(jm, pm, qpos, qvel,
                                      np.zeros((0, k), np.float32), 4)
  assert max(e[0] for e in errs) <= TOL_QPOS, errs
  assert max(e[1] for e in errs) <= TOL_QVEL, errs
  # the floor pushed back: slower than 4 steps of free fall
  assert (jv[2] > -0.2 - 4 * 0.002 * 9.81 + 0.02).all(), jv[2]


def test_walker_capsule_ground_steps_match_jax():
  """Walker's plan model: 7 plane-capsule pairs, 14 end points, feet pressed
  into the floor, limited hinges."""
  jm = _jax_plan_model("Walker")
  pm = _port_model(jm)
  assert len(tstep._contact_plan(pm, tstep._static(pm), None, None)) == 14
  k = 3
  rng = np.random.default_rng(12)
  qpos = np.tile(to_np(pm.qpos0)[:, None], (1, k)).astype(np.float32)
  qpos[3:] += 0.1 * rng.standard_normal((pm.nq - 3, k)).astype(np.float32)
  # rootz is the second joint (a slide): lower each lane onto the floor
  assert int(pm.jnt_type[1]) == tmodel.SLIDE
  qpos[1] -= clearances(pm, qpos) + np.array([0.0005, 0.0015, 0.003])
  qvel = (0.3 * rng.standard_normal((pm.nv, k))).astype(np.float32)
  ctrl = rng.uniform(-1, 1, (pm.nu, k)).astype(np.float32)
  errs, _, _ = _steps_from_jax_state(jm, pm, qpos, qvel, ctrl, 3)
  assert max(e[0] for e in errs) <= TOL_QPOS, errs
  assert max(e[1] for e in errs) <= TOL_QVEL, errs


def test_quadrotor_site_transmission_steps_match_jax():
  """Four site-transmission rotors with asymmetric thrusts (force and yaw
  torque rows of the site moment), airborne, and one lane whose box core
  rests on the floor; states and the 13 residual rows for 3 steps."""
  jt = jregistry.get_task("Quadrotor")
  pt = tregistry.get_task("Quadrotor", device="cpu")
  jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  jk = jstep.build_rollout_kernel(
      jt.plan_model, 3, 1, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  pk = tstep.build_rollout_kernel(pt.plan_model, 3, 1, residual=pspec,
                                  naux=pspec["naux"])
  assert pk.build_defines()["LR_SITE"] == 1
  k = 4
  rng = np.random.default_rng(19)
  qpos = np.tile(np.asarray(pt.home_qpos)[:, None], (1, k))
  qpos[2] += 0.5 + 0.1 * rng.standard_normal(k)
  qpos[3:7] += 0.05 * rng.standard_normal((4, k))
  qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
  qpos = qpos.astype(np.float32)
  qpos[:, 3] = [0, 0, 0.029, 1, 0, 0, 0]       # core 1 mm into the floor
  qvel = (0.2 * rng.standard_normal((6, k))).astype(np.float32)
  ctrl = rng.uniform(0.5, 3.0, (4, k)).astype(np.float32)
  d0 = pt.make_data()
  aux = np.tile(to_np(pspec["make_aux"](d0, pt.residual_params))[:, None],
                (1, k)).astype(np.float32)
  jq, jv = jnp.asarray(qpos), jnp.asarray(qvel)
  with jax.disable_jit():
    for t in range(3):
      pq, pv, pres = pk.step_array(tt(np.array(jq)), tt(np.array(jv)),
                                   tt(ctrl), t, tt(aux))
      jq, jv, jres = jk.step_array(jq, jv, jnp.asarray(ctrl), t,
                                   jnp.asarray(aux))
      np.testing.assert_allclose(to_np(pres), np.asarray(jres),
                                 atol=TOL_ROWS, err_msg=f"rows t={t}")
      np.testing.assert_allclose(to_np(pq), np.asarray(jq), atol=TOL_QPOS,
                                 err_msg=f"qpos t={t}")
      np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=TOL_QVEL,
                                 err_msg=f"qvel t={t}")
  assert np.asarray(jv)[2, 3] > qvel[2, 3] - 9.81 * 0.03   # floor held it


@pytest.mark.parametrize("name", ["Humanoid Stand", "Humanoid Walk",
                                  "Humanoid Track"])
def test_humanoid_lane_residual_rows_match_jax(name):
  """The lane residual rows (derived quantities only) at t = 0, 2, 3 on
  perturbed, moving states; Track with random per-step aux rows."""
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  horizon = 4
  if name == "Humanoid Track":
    jspec = jt.lane_residual_spec(horizon=horizon)
    pspec = pt.lane_residual_spec(horizon=horizon)
    assert pspec["naux_static"] == 0
  else:
    jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  assert pspec["dim"] == jspec["dim"] and pspec["naux"] == jspec["naux"]
  jk = jstep.build_rollout_kernel(
      jt.plan_model, horizon, 1, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  pk = tstep.build_rollout_kernel(pt.plan_model, horizon, 1, residual=pspec,
                                  naux=pspec["naux"])
  k = 3
  rng = np.random.default_rng(21)
  qpos = np.tile(np.asarray(pt.home_qpos)[:, None], (1, k))
  qpos[:3] += 0.1 * rng.standard_normal((3, k))
  qpos[3:7] += 0.1 * rng.standard_normal((4, k))
  qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
  qpos[7:] += 0.3 * rng.standard_normal((21, k))
  qpos = qpos.astype(np.float32)
  qvel = rng.standard_normal((27, k)).astype(np.float32)
  ctrl = rng.uniform(-1, 1, (21, k)).astype(np.float32)
  aux = rng.uniform(0.5, 1.5, (pspec["naux"], k)).astype(np.float32)
  for t in (0, 2, 3):
    with jax.disable_jit():
      want = np.asarray(jk.residual_array(
          jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl), t,
          jnp.asarray(aux)))
    got = to_np(pk.residual_array(tt(qpos), tt(qvel), tt(ctrl), t, tt(aux)))
    assert got.shape == (jspec["dim"], k)
    np.testing.assert_allclose(got, want, atol=TOL_ROWS, err_msg=f"t={t}")


@pytest.mark.parametrize("time", [0.0, 0.3701, 3.95, 5.0])
def test_tracking_clip_and_aux_rows_match_jax(time):
  """The procedural clip, and make_aux's per-step rows (pos 18, vel 18 at
  d0.time + h t, row t*36 + i) at a fractional time and past the clip's
  end (the interpolation clamps)."""
  np.testing.assert_allclose(ttracking.make_walk_clip(),
                             jtracking.make_walk_clip(), atol=TOL_CLIP)
  jt = jregistry.get_task("Humanoid Track")
  pt = tregistry.get_task("Humanoid Track", device="cpu")
  horizon = 25
  jaux = jt.lane_residual_spec(horizon=horizon)["make_aux"]
  paux = pt.lane_residual_spec(horizon=horizon)["make_aux"]
  jd0 = jt.make_data().replace(time=jnp.asarray(time, jnp.float32))
  pd0 = pt.make_data().replace(time=torch.tensor(time))
  want = np.asarray(jaux(jd0, jt.residual_params))
  got = to_np(paux(pd0, pt.residual_params))
  assert got.shape == (horizon * 36,)
  np.testing.assert_allclose(got, want, atol=TOL_CLIP)


class _SpecRaises:
  """A task whose time-varying spec fails inside: the TypeError must reach
  the caller, not be taken for a spec without a horizon."""

  def __init__(self, task):
    self.model = self.plan_model = task.plan_model
    self.cost_spec = task.cost_spec

  def lane_residual_spec(self, horizon):
    raise TypeError("failure inside the spec")


def test_lane_planner_passes_the_horizon_to_a_time_varying_spec():
  pt = tregistry.get_task("Humanoid Track", device="cpu")
  config = tsampling.SamplingConfig(
      num_trajectory=4, num_spline_points=2, interp=Interpolation.ZERO,
      exploration=(0.08, 0.0), horizon=5)
  planner = tsampling_lane.LaneSamplingPlanner(pt, config, device="cpu")
  defs = planner._optimize.returns_fn.kernel.build_defines()
  assert (defs["LR_NAUX"], defs["LR_NAUXS"]) == (5 * 36, 0)
  assert planner.routes == dict(rollouts="rollout_kernel",
                                scoring="rollout_kernel")
  with pytest.raises(TypeError, match="inside the spec"):
    tsampling_lane.make_lane_returns_fn(_SpecRaises(pt), config)


def test_ilqg_lane_route_refuses_a_time_varying_spec_by_name():
  from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
  pt = tregistry.get_task("Humanoid Track", device="cpu")
  with pytest.raises(NotImplementedError, match="per-step aux rows"):
    tilqg.ILQGPlanner(pt, lane=True, device="cpu")


HUMANOID_HORIZON, HUMANOID_P, HUMANOID_K = 3, 2, 2
HUMANOID_TIME0 = 0.41


def _humanoid_start(pt):
  rng = np.random.default_rng(31)
  qpos0 = np.asarray(pt.home_qpos, np.float32)
  qpos0[2] -= clearances(pt.plan_model, qpos0[:, None])[0] + 0.0007
  qvel0 = (0.1 * rng.standard_normal(27)).astype(np.float32)
  cand = rng.uniform(-0.4, 0.4, (HUMANOID_K, HUMANOID_P, 21)).astype(
      np.float32)
  return qpos0, qvel0, cand


def _humanoid_track_jax():
  """The JAX side of `humanoid_track` as numpy arrays: each step's state
  and control, the returns, the aux rows."""
  jt = jregistry.get_task("Humanoid Track")
  pt = tregistry.get_task("Humanoid Track", device="cpu")
  horizon, p, k = HUMANOID_HORIZON, HUMANOID_P, HUMANOID_K
  jspec = jt.lane_residual_spec(horizon=horizon)
  jk = jstep.build_rollout_kernel(
      jt.plan_model, horizon, p, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  qpos0, qvel0, cand = _humanoid_start(pt)
  node_of = [min(int(t * p / (horizon - 1)), p - 1) for t in range(horizon)]
  cs = pt.cost_spec
  jd0 = jt.make_data().replace(time=jnp.asarray(HUMANOID_TIME0, jnp.float32))
  aux = np.concatenate([np.asarray(jspec["make_aux"](jd0,
                                                     jt.residual_params)),
                        to_np(cs.norm_params[:, :2]).reshape(-1)])
  aux = np.tile(aux[:, None], (1, k)).astype(np.float32)
  jq = jnp.asarray(np.tile(qpos0[:, None], (1, k)))
  jv = jnp.asarray(np.tile(qvel0[:, None], (1, k)))
  qs, vs, ctrls, sums = [], [], [], np.zeros((len(cs.dims), k))
  norm_p = to_np(cs.norm_params)
  with jax.disable_jit():
    for t in range(horizon):
      ctrl = jnp.asarray(cand[:, node_of[t]].T)
      qs.append(np.asarray(jq))
      vs.append(np.asarray(jv))
      ctrls.append(np.asarray(ctrl))
      jq, jv, jres = jk.step_array(jq, jv, ctrl, t, jnp.asarray(aux))
      off = 0
      for n, (ntype, dim) in enumerate(zip(cs.norm_types, cs.dims)):
        sums[n] += np.asarray(jstep.lane_term_cost(
            [jres[off + i] for i in range(dim)], ntype,
            jnp.asarray(norm_p[n, 0]), jnp.asarray(norm_p[n, 1])))
        off += dim
  qs.append(np.asarray(jq))
  vs.append(np.asarray(jv))
  returns = (to_np(cs.weights)[:, None] * sums).sum(axis=0) / horizon
  return dict(qpos=np.stack(qs), qvel=np.stack(vs), ctrl=np.stack(ctrls),
              returns=returns, aux=aux)


@pytest.fixture(scope="module")
def humanoid_track(tmp_path_factory):
  """Humanoid Track, 3 steps from a standing pose with the feet 0.5-1 mm in
  the floor (box corners and the shin capsules' ends near it), two
  injected candidates (P=2); the JAX side chains its own steps eagerly and
  scores them as the lane planner does (per-term norm sums, weighted, mean
  over the horizon), once a test session (`once_a_session`: its two tests
  may land on two workers)."""
  j = once_a_session(tmp_path_factory, "humanoid_track_jax",
                     _humanoid_track_jax)
  pt = tregistry.get_task("Humanoid Track", device="cpu")
  qpos0, qvel0, cand = _humanoid_start(pt)
  horizon = HUMANOID_HORIZON
  states = [(j["qpos"][t], j["qvel"][t], j["ctrl"][t] if t < horizon
             else None) for t in range(horizon + 1)]
  d0 = tmodel.make_data(pt.plan_model).replace(
      qpos=tt(qpos0), qvel=tt(qvel0), time=torch.tensor(HUMANOID_TIME0))
  return dict(pt=pt, states=states, returns=j["returns"], cand=cand, d0=d0,
              horizon=horizon, p=HUMANOID_P, aux=j["aux"])


def test_humanoid_steps_match_jax(humanoid_track):
  """One humanoid step at a time from the JAX state: 39 ground contact
  points (sphere head, capsule limbs, box feet), 21 limited joints."""
  h = humanoid_track
  pt = h["pt"]
  spec = pt.lane_residual_spec(horizon=h["horizon"])
  pk = tstep.build_rollout_kernel(pt.plan_model, h["horizon"], h["p"],
                                  residual=spec, naux=spec["naux"])
  for t in range(h["horizon"]):
    q, v, ctrl = h["states"][t]
    q_next, v_next, _ = h["states"][t + 1]
    pq, pv, _ = pk.step_array(tt(q), tt(v), tt(ctrl), t, tt(h["aux"]))
    np.testing.assert_allclose(to_np(pq), q_next, atol=TOL_QPOS,
                               err_msg=f"qpos t={t}")
    np.testing.assert_allclose(to_np(pv), v_next, atol=TOL_QVEL,
                               err_msg=f"qvel t={t}")


def test_humanoid_track_lane_returns_match_jax(humanoid_track):
  """`make_lane_returns_fn` on Humanoid Track (H=3, K=2, injected
  candidates, cost sums in the rollout, per-step aux rows) against the JAX
  package's steps and norms."""
  h = humanoid_track
  config = tsampling.SamplingConfig(
      num_trajectory=2, num_spline_points=h["p"], interp=Interpolation.ZERO,
      exploration=(0.08, 0.0), horizon=h["horizon"])
  returns_fn = tsampling_lane.make_lane_returns_fn(h["pt"], config)
  assert returns_fn.routes["scoring"] == "rollout_kernel"
  got = to_np(returns_fn(tt(h["cand"]), h["d0"]))
  np.testing.assert_allclose(got, h["returns"], rtol=TOL_RETURN_REL)
