"""Port vs JAX: one physics step of the lane rollout kernel's plain version
(`.step_array`) against the JAX package's `step_array` — the same
step_body its Pallas kernel runs — on the same numpy inputs.

Tolerances are the JAX suite's own: 2e-4 on states (kernel vs pipeline),
5e-4 on residual rows, 1e-4 relative on per-term cost sums. The JAX side
runs eagerly (`jax.disable_jit`): compiling the quadruped step for the CPU
takes minutes, op-by-op dispatch seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.physics import collision as jcoll
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests import models as tm
from tests.torch_port_helpers import (BALL, LIMITED, MIXED_CONTACTS,
                                      models_from_xml, to_np, tt)

TOL_STATE = 2e-4
TOL_ROWS = 5e-4
TOL_SUMS_REL = 1e-4

def _chain_steps(jm, pm, qpos, qvel, ctrl, steps, from_jax_state=False,
                 **kw):
  """Each package chains its own steps from the same start (or, with
  from_jax_state, the port restarts every step from the JAX state);
  returns the per-step max abs state difference."""
  jk = jstep.build_rollout_kernel(jm, 2, 1, interpret=True, **kw)
  pk = tstep.build_rollout_kernel(pm, 2, 1, **kw)
  jq, jv = jnp.asarray(qpos), jnp.asarray(qvel)
  pq, pv = tt(qpos), tt(qvel)
  errs = []
  with jax.disable_jit():
    for t in range(steps):
      if from_jax_state:
        pq, pv = tt(np.array(jq)), tt(np.array(jv))
      jq, jv = jk.step_array(jq, jv, jnp.asarray(ctrl), t)[:2]
      pq, pv = pk.step_array(pq, pv, tt(ctrl), t)[:2]
      assert np.isfinite(to_np(pq)).all() and np.isfinite(to_np(pv)).all()
      errs.append(max(np.abs(to_np(pq) - np.asarray(jq)).max(),
                      np.abs(to_np(pv) - np.asarray(jv)).max()))
  return errs, to_np(pq), to_np(pv)


def test_contact_free_hinge_chain_matches_jax():
  jm, pm, mjm = models_from_xml(tm.CHAIN)
  assert tstep.supports(pm) and jstep.supports(jm)
  rng = np.random.default_rng(0)
  k = 4
  qpos = np.tile(mjm.qpos0[:, None], (1, k)) + 0.4 * rng.standard_normal(
      (pm.nq, k))
  qvel = rng.standard_normal((pm.nv, k))
  ctrl = rng.uniform(-1.5, 1.5, (pm.nu, k))    # beyond the ctrl clamp too
  errs, _, _ = _chain_steps(jm, pm, qpos.astype(np.float32),
                            qvel.astype(np.float32),
                            ctrl.astype(np.float32), 6)
  assert max(errs) <= TOL_STATE, errs


def test_joint_limits_and_position_actuator_match_jax():
  jm, pm, mjm = models_from_xml(LIMITED)
  assert tstep.supports(pm)
  k = 4
  qpos = np.array([[0.49, -0.52, 0.2, 0.0],
                   [0.68, -0.55, 0.72, 0.1]], np.float32)   # at/over limits
  qvel = np.array([[1.0, -1.0, 0.5, 0.0],
                   [2.0, -2.0, 1.0, 0.0]], np.float32)
  ctrl = np.array([[1.5, -1.0, 0.3, 0.0],
                   [0.5, -0.5, 1.0, 0.0]], np.float32)
  errs, pq, _ = _chain_steps(jm, pm, qpos, qvel, ctrl, 6)
  assert max(errs) <= TOL_STATE, errs
  # the limit rows did something: the slide was pushed back inside
  assert pq[0, 0] < 0.52 and pq[0, 1] > -0.56


@pytest.mark.parametrize("cone,condim,floor_condim,impratio", [
    ("pyramidal", 1, 1, 1.0), ("pyramidal", 3, 3, 1.0),
    ("pyramidal", 4, 3, 1.0), ("pyramidal", 6, 3, 10.0),
    ("elliptic", 1, 1, 1.0), ("elliptic", 3, 3, 1.0),
    ("elliptic", 4, 3, 1.0), ("elliptic", 6, 3, 1.0),
    ("elliptic", 6, 3, 10.0)])
def test_free_body_on_plane_matches_jax(cone, condim, floor_condim, impratio):
  """Sliding, spinning ball pressed into the floor: pyramidal rows,
  the frictionless single row, and elliptic cone blocks at condim 3/4/6
  (torsion and rolling rows, impratio stiffening)."""
  jm, pm, mjm = models_from_xml(BALL.format(
      cone=cone, condim=condim, floor_condim=floor_condim,
      impratio=impratio))
  assert tstep.supports(pm, ground_only=True)
  assert int(pm.collision_pairs.con_condim[0]) == condim
  k = 4
  qpos = np.tile(mjm.qpos0[:, None], (1, k)).astype(np.float32)
  qpos[2] = [0.0995, 0.098, 0.1, 0.12]     # pressed in ... just above
  qvel = np.zeros((pm.nv, k), np.float32)
  qvel[0] = 0.8    # tangential slide
  qvel[2] = -0.5   # pressing down
  qvel[3] = 3.0    # roll about x
  qvel[5] = 6.0    # spin about the normal (torsion)
  ctrl = np.zeros((0, k), np.float32)
  errs, pq, pv = _chain_steps(jm, pm, qpos, qvel, ctrl, 5)
  assert max(errs) <= TOL_STATE, errs
  assert pv[2, 0] > -0.5     # the floor pushed back


def test_bouncing_ball_default_friction_matches_jax():
  jm, pm, mjm = models_from_xml(tm.BOUNCE)
  k = 4
  qpos = np.tile(mjm.qpos0[:, None], (1, k)).astype(np.float32)
  qpos[2] = [0.16, 0.101, 0.099, 0.09]
  qvel = np.zeros((pm.nv, k), np.float32)
  qvel[2] = -0.5
  qvel[1] = [0.0, 0.3, -0.3, 1.0]
  errs, _, _ = _chain_steps(jm, pm, qpos, qvel,
                            np.zeros((0, k), np.float32), 5)
  assert max(errs) <= TOL_STATE, errs


def test_two_elliptic_contacts_of_different_condim_match_jax():
  """A free ball (condim 6) and a hinged arm's sphere tip (condim 3) on the
  floor at once; the ball-arm pair is dropped (ground only). Every step
  starts from the JAX state: here a 7e-6 difference after the second step
  flips a solver gate in the third (0.37 apart), in either package."""
  jm, pm, mjm = models_from_xml(MIXED_CONTACTS)
  assert tstep.supports(pm, ground_only=True)
  k = 4
  qpos = np.tile(mjm.qpos0[:, None], (1, k)).astype(np.float32)
  qpos[2] = [0.0995, 0.098, 0.1, 0.12]
  qpos[7] = [0.68, 0.70, 0.66, 0.3]        # tip in, deeper, just out, up
  qvel = np.zeros((pm.nv, k), np.float32)
  qvel[0], qvel[5], qvel[6] = 0.5, 4.0, 1.0
  errs, _, pv = _chain_steps(jm, pm, qpos, qvel,
                             np.zeros((0, k), np.float32), 5,
                             from_jax_state=True)
  assert max(errs) <= TOL_STATE, errs
  assert pv[6, 0] < 0.5      # the floor slowed the arm that was pressed in


def test_unported_model_classes_are_refused_not_dropped():
  # capsule and box ground contacts are in the kernel's class; what is not
  # (activation states, friction loss, body-body pairs) is refused with
  # its name, never dropped
  jm, pm, _ = models_from_xml(tm.CAPSULE_FLOOR)
  assert tstep.supports(pm, ground_only=True) and jstep.supports(
      jm, ground_only=True)
  assert not tstep.supports(pm)             # pairs, unless ground only
  _, act, _ = models_from_xml(tm.ACTLIMITED)
  assert not tstep.supports(act, ground_only=True)
  with pytest.raises(NotImplementedError, match="activation states"):
    tstep.build_rollout_kernel(act, 4, 1)
  quad = tregistry.get_task("Quadruped Flat", device="cpu").plan_model
  assert not tstep.supports(quad)                      # self-collisions
  assert tstep.supports(quad, ground_only=True)        # capsule/box ground
  # a fluid medium is inside the kernel class; friction loss is not
  fluid = quad.replace(opt=quad.opt.replace(density=torch.tensor(1.2)))
  assert tstep.supports(fluid, ground_only=True)
  lossy = quad.replace(dof_frictionloss=torch.full((quad.nv,), 0.1))
  assert not tstep.supports(lossy, ground_only=True)
  with pytest.raises(NotImplementedError, match="friction loss"):
    tstep.build_rollout_kernel(lossy, 4, 1, contact_types=(GEOM_SPHERE,))
  with pytest.raises(ValueError):           # feedback mode records states
    tstep.build_rollout_kernel(
        tregistry.get_task("Cartpole", device="cpu").plan_model, 4, 1,
        record_states=False, feedback=True,
        residual=dict(fn=lambda ctx: [], dim=0))


@pytest.fixture(scope="module")
def quadruped():
  jt = jregistry.get_task("Quadruped Flat")
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  jk = jstep.build_rollout_kernel(
      jt.plan_model, 3, 2, interpret=True, contact_types=(jcoll.SPHERE,),
      contact_geoms=jt.plan_contact_geoms, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  pk = tstep.build_rollout_kernel(
      pt.plan_model, 3, 2, contact_types=(GEOM_SPHERE,),
      contact_geoms=pt.plan_contact_geoms, residual=pspec,
      naux=pspec["naux"])
  # lanes: home, crouch, a penetrating state, home with velocity
  crouch = np.array([0, 0, 0.16, 1, 0, 0, 0] + [0, 1.2, -2.4] * 4)
  home = np.asarray(pt.home_qpos)
  pen = home.copy()
  pen[2] = 0.255                      # feet ~1.5 cm into the floor
  qpos = np.stack([home, crouch, pen, home], axis=1).astype(np.float32)
  rng = np.random.default_rng(7)
  qvel = np.zeros((18, 4), np.float32)
  qvel[:, 3] = 0.2 * rng.standard_normal(18)
  ctrl = np.stack([home[7:], crouch[7:], home[7:],
                   home[7:] + 0.1 * rng.standard_normal(12)],
                  axis=1).astype(np.float32)
  d0 = pt.make_data().replace(time=torch.tensor(0.37))
  aux = np.tile(to_np(pspec["make_aux"](d0, pt.residual_params))[:, None],
                (1, 4)).astype(np.float32)
  return dict(jt=jt, pt=pt, jk=jk, pk=pk, qpos=qpos, qvel=qvel, ctrl=ctrl,
              aux=aux)


def test_quadruped_three_chained_steps_match_jax(quadruped):
  """Home, crouch, a penetrating state and a moving state: states, the 42
  residual rows and the per-term cost sums over the three steps."""
  q = quadruped
  spec = q["pt"].cost_spec
  jq, jv = jnp.asarray(q["qpos"]), jnp.asarray(q["qvel"])
  pq, pv = tt(q["qpos"]), tt(q["qvel"])
  jaux, paux = jnp.asarray(q["aux"]), tt(q["aux"])
  jsums = np.zeros((9, 4), np.float64)
  psums = np.zeros((9, 4), np.float64)
  norm_p = to_np(spec.norm_params)
  with jax.disable_jit():
    for t in range(3):
      jq, jv, jres = q["jk"].step_array(jq, jv, jnp.asarray(q["ctrl"]), t,
                                        jaux)
      pq, pv, pres = q["pk"].step_array(pq, pv, tt(q["ctrl"]), t, paux)
      assert pres.shape == (42, 4)
      np.testing.assert_allclose(to_np(pres), np.asarray(jres),
                                 atol=TOL_ROWS, err_msg=f"rows t={t}")
      np.testing.assert_allclose(to_np(pq), np.asarray(jq), atol=TOL_STATE,
                                 err_msg=f"qpos t={t}")
      np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=TOL_STATE,
                                 err_msg=f"qvel t={t}")
      off = 0
      for n, (ntype, dim) in enumerate(zip(spec.norm_types, spec.dims)):
        jrows = [jres[off + i] for i in range(dim)]
        prows = [pres[off + i] for i in range(dim)]
        jsums[n] += np.asarray(jstep.lane_term_cost(
            jrows, ntype, jnp.asarray(norm_p[n, 0]),
            jnp.asarray(norm_p[n, 1])))
        psums[n] += to_np(tstep.lane_term_cost(
            prows, ntype, tt(norm_p[n, 0]), tt(norm_p[n, 1])))
        off += dim
  np.testing.assert_allclose(psums, jsums, rtol=TOL_SUMS_REL, atol=1e-6)
  # the feet met the floor: the penetrating lane was pushed up
  assert to_np(pv)[2, 2] > 0.0


def test_quadruped_residual_array_matches_jax(quadruped):
  q = quadruped
  rng = np.random.default_rng(3)
  qpos = q["qpos"].copy()
  qpos[7:] += 0.05 * rng.standard_normal((12, 4)).astype(np.float32)
  qvel = (0.3 * rng.standard_normal((18, 4))).astype(np.float32)
  ctrl = rng.uniform(-0.3, 0.3, (12, 4)).astype(np.float32)
  with jax.disable_jit():
    want = np.asarray(q["jk"].residual_array(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl), 5,
        jnp.asarray(q["aux"])))
  got = to_np(q["pk"].residual_array(tt(qpos), tt(qvel), tt(ctrl), 5,
                                     tt(q["aux"])))
  assert got.shape == (42, 4)
  np.testing.assert_allclose(got, want, atol=TOL_ROWS)


@pytest.mark.parametrize("mode", ["states", "residual_rows", "cost_sums"])
def test_rollout_output_modes_agree_with_chained_steps(quadruped, mode):
  """The three output modes of the port's rollout are the same chained
  steps: recorded pre-step states (+ rows), rows + final state, per-term
  norm sums + final state; spline nodes are held zero-order."""
  q = quadruped
  pt = q["pt"]
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  horizon, p, k = 3, 2, 4
  cost_terms = tuple(zip(cs.norm_types, cs.dims)) \
      if mode == "cost_sums" else None
  kern = tstep.build_rollout_kernel(
      pt.plan_model, horizon, p, contact_types=(GEOM_SPHERE,),
      contact_geoms=pt.plan_contact_geoms, residual=spec,
      naux=spec["naux"], record_states=(mode == "states"),
      cost_terms=cost_terms)
  rng = np.random.default_rng(5)
  values = np.concatenate([q["ctrl"], q["ctrl"] + 0.05 * rng.standard_normal(
      (12, k)).astype(np.float32)])                       # (P*nu, K)
  aux = q["aux"]
  if mode == "cost_sums":
    aux = np.concatenate([aux, np.tile(
        to_np(cs.norm_params[:, :2]).reshape(-1, 1), (1, k))])
  out = kern(tt(q["qpos"]), tt(q["qvel"]), tt(values), tt(aux))
  # chained single steps; node_of_step = min(int(t*P/(H-1)), P-1) = 0, 1, 1
  pq, pv = tt(q["qpos"]), tt(q["qvel"])
  states, rows = [], []
  for t, node in enumerate([0, 1, 1]):
    states.append(torch.cat([pq, pv]))
    pq, pv, res = q["pk"].step_array(
        pq, pv, tt(values[node * 12:(node + 1) * 12]), t, tt(q["aux"]))
    rows.append(res)
  final = torch.cat([pq, pv])
  if mode == "states":
    assert out.shape == (horizon, 19 + 18 + 42, k)
    torch.testing.assert_close(out[:, :37], torch.stack(states))
    torch.testing.assert_close(out[:, 37:], torch.stack(rows))
  elif mode == "residual_rows":
    torch.testing.assert_close(out[0], torch.stack(rows))
    torch.testing.assert_close(out[1], final)
  else:
    want = cs.cost_terms(torch.stack(rows).movedim(1, -1),
                         weighted=False).sum(dim=0).T       # (nterm, K)
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[1], final)
