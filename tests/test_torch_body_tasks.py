"""Port vs JAX on the hand tasks' planning models (plain versions, on the
CPU): Hand Reorient steps from the same state and its lane planner returns
(cost sums in the rollout, injected candidates), and one Rubik step on a
subset of its planning contacts that keeps capsule-capsule and capsule-box
pairs (a JAX step on all 230 contact points takes ~40 s eagerly).

Tolerances: 2e-4 on qpos and 2e-3 on qvel for one step from the same
state, 1e-4 relative on returns. The JAX side runs eagerly
(`jax.disable_jit`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.ops import sampling_lane as tsampling_lane
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics import model as tmodel
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.spline import Interpolation
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.test_torch_body_pairs import _hand_states
from tests.torch_port_helpers import to_np, tt

TOL_QPOS = 2e-4
TOL_QVEL = 2e-3
TOL_RETURN_REL = 1e-4


@pytest.fixture(scope="module")
def hand_reorient():
  """Hand Reorient, 2 steps of 8 injected candidates (P=2) from home poses
  with the cube pressed 1-3 mm into a fingertip; the JAX side chains its
  own steps eagerly and scores them as the lane planner does (per-term norm
  sums, weighted, mean over the horizon)."""
  jt = jregistry.get_task("Hand Reorient")
  pt = tregistry.get_task("Hand Reorient", device="cpu")
  horizon, p, k = 2, 2, 8
  jspec = jt.lane_residual_spec()
  jk = jstep.build_rollout_kernel(
      jt.plan_model, horizon, p, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"],
      contact_geoms=jt.plan_contact_geoms, body_pairs=True)
  rng = np.random.default_rng(51)
  qpos, qvel = _hand_states(pt, k, rng)
  # the planner rolls every candidate from ONE state: take lane 1's
  qpos0, qvel0 = qpos[:, 1].copy(), qvel[:, 1].copy()
  nu = pt.plan_model.nu
  lo = to_np(pt.plan_model.actuator_ctrlrange[:, 0])
  hi = to_np(pt.plan_model.actuator_ctrlrange[:, 1])
  cand = rng.uniform(lo, hi, (k, p, nu)).astype(np.float32)
  node_of = [min(int(t * p / (horizon - 1)), p - 1) for t in range(horizon)]
  cs = pt.cost_spec
  goal = np.array([0.9, 0.1, -0.3, 0.3], np.float32)
  goal /= np.linalg.norm(goal)
  jd0 = jt.make_data().replace(mocap_quat=jnp.asarray(goal[None]))
  aux = np.concatenate([np.asarray(jspec["make_aux"](jd0,
                                                     jt.residual_params)),
                        to_np(cs.norm_params[:, :2]).reshape(-1)])
  aux = np.tile(aux[:, None], (1, k)).astype(np.float32)
  jq = jnp.asarray(np.tile(qpos0[:, None], (1, k)))
  jv = jnp.asarray(np.tile(qvel0[:, None], (1, k)))
  states, sums = [], np.zeros((len(cs.dims), k))
  norm_p = to_np(cs.norm_params)
  with jax.disable_jit():
    for t in range(horizon):
      ctrl = jnp.asarray(cand[:, node_of[t]].T)
      states.append((np.asarray(jq), np.asarray(jv), np.asarray(ctrl)))
      jq, jv, jres = jk.step_array(jq, jv, ctrl, t, jnp.asarray(aux))
      off = 0
      for n, (ntype, dim) in enumerate(zip(cs.norm_types, cs.dims)):
        sums[n] += np.asarray(jstep.lane_term_cost(
            [jres[off + i] for i in range(dim)], ntype,
            jnp.asarray(norm_p[n, 0]), jnp.asarray(norm_p[n, 1])))
        off += dim
  states.append((np.asarray(jq), np.asarray(jv), None))
  returns = (to_np(cs.weights)[:, None] * sums).sum(axis=0) / horizon
  d0 = tmodel.make_data(pt.plan_model).replace(
      qpos=tt(qpos0), qvel=tt(qvel0), mocap_quat=tt(goal[None]))
  return dict(pt=pt, states=states, returns=returns, cand=cand, d0=d0,
              horizon=horizon, p=p, aux=aux)


def test_hand_reorient_steps_match_jax(hand_reorient):
  """One step at a time from the JAX state: fingertip capsules against the
  cube box (body pairs), the cube on the palm plane, 20 limited joints."""
  h = hand_reorient
  pt = h["pt"]
  spec = pt.lane_residual_spec()
  pk = tstep.build_rollout_kernel(
      pt.plan_model, h["horizon"], h["p"], residual=spec, naux=spec["naux"],
      contact_geoms=pt.plan_contact_geoms, body_pairs=True)
  defs = pk.build_defines()
  assert (defs["LR_NCON"], defs["LR_NBCON"]) == (18, 10)
  for t in range(h["horizon"]):
    q, v, ctrl = h["states"][t]
    q_next, v_next, _ = h["states"][t + 1]
    pq, pv, _ = pk.step_array(tt(q), tt(v), tt(ctrl), t, tt(h["aux"]))
    np.testing.assert_allclose(to_np(pq), q_next, atol=TOL_QPOS,
                               err_msg=f"qpos t={t}")
    np.testing.assert_allclose(to_np(pv), v_next, atol=TOL_QVEL,
                               err_msg=f"qvel t={t}")


def test_hand_reorient_lane_returns_match_jax(hand_reorient):
  """`make_lane_returns_fn` on Hand Reorient (H=2, K=8, injected
  candidates): the task's body pairs and planning contacts reach the
  kernel, cost sums in the rollout."""
  h = hand_reorient
  config = tsampling.SamplingConfig(
      num_trajectory=8, num_spline_points=h["p"], interp=Interpolation.ZERO,
      exploration=(0.25, 0.0), horizon=h["horizon"])
  returns_fn = tsampling_lane.make_lane_returns_fn(h["pt"], config)
  assert returns_fn.routes["scoring"] == "rollout_kernel"
  defs = returns_fn.kernel.build_defines()
  assert (defs["LR_BODY"], defs["LR_NCON"], defs["LR_NBCON"]) == (1, 18, 10)
  got = to_np(returns_fn(tt(h["cand"]), h["d0"]))
  np.testing.assert_allclose(got, h["returns"], rtol=TOL_RETURN_REL)


def test_rubik_step_on_a_contact_subset_matches_jax():
  """One Rubik step on a subset of its planning contacts, passed to both
  packages: the palm plane, fingertips 0 and 1, middle link 0, the core
  and two knobs — capsule-capsule pairs (fingertips 14 mm into each other
  at home), capsule-box pairs (a middle link 2 mm into the yellow knob),
  the knob-knob box-box pairs dropped by the task's whitelist."""
  jt = jregistry.get_task("Rubik")
  pt = tregistry.get_task("Rubik", device="cpu")
  names = pt.plan_model.names["geom"]
  subset = frozenset(names.index(n) for n in (
      "palm", "ft_0", "ft_1", "fm_0", "core", "knob_yellow", "knob_red"))
  horizon = 2
  jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  jk = jstep.build_rollout_kernel(
      jt.plan_model, horizon, 1, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"], contact_geoms=subset,
      body_pairs=True, body_pair_types=jt.plan_body_pair_types)
  pk = tstep.build_rollout_kernel(
      pt.plan_model, horizon, 1, residual=pspec, naux=pspec["naux"],
      contact_geoms=subset, body_pairs=True,
      body_pair_types=pt.plan_body_pair_types)
  defs = pk.build_defines()
  # ground: 3 capsules (6 ends) and 3 boxes (24 corners); body: 2
  # capsule-capsule pairs and 9 capsule-box pairs (18 ends)
  assert (defs["LR_NCON"], defs["LR_NBCON"]) == (30, 20)
  k = 3
  rng = np.random.default_rng(53)
  qpos = np.tile(np.asarray(pt.home_qpos, np.float32)[:, None], (1, k))
  qpos[:9] += (0.02 * rng.standard_normal((9, k))).astype(np.float32)
  qvel = (0.05 * rng.standard_normal((pt.plan_model.nv, k))).astype(
      np.float32)
  ctrl = rng.uniform(-0.3, 1.5, (pt.plan_model.nu, k)).astype(np.float32)
  aux = np.tile(to_np(pspec["make_aux"](pt.make_data(),
                                        pt.residual_params))[:, None], (1, k))
  with jax.disable_jit():
    jq, jv, jres = jk.step_array(jnp.asarray(qpos), jnp.asarray(qvel),
                                 jnp.asarray(ctrl), 0, jnp.asarray(aux))
  pq, pv, pres = pk.step_array(tt(qpos), tt(qvel), tt(ctrl), 0, tt(aux))
  np.testing.assert_allclose(to_np(pres), np.asarray(jres), atol=5e-4)
  np.testing.assert_allclose(to_np(pq), np.asarray(jq), atol=TOL_QPOS)
  np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=TOL_QVEL)
  # the contacts pushed: the hand's joint velocities left their free course
  free = tstep.build_rollout_kernel(pt.plan_model, horizon, 1,
                                    contact_geoms=frozenset(),
                                    residual=pspec, naux=pspec["naux"])
  fv = to_np(free.step_array(tt(qpos), tt(qvel), tt(ctrl), 0, tt(aux))[1])
  assert np.abs(fv - np.asarray(jv)).max() > 10 * TOL_QVEL
  assert torch.isfinite(pv).all()
