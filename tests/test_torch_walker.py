"""Walker in the port against the JAX package: the pipeline residual, the
lane residual in the rollout kernel's plain version (held to JAX's lane
kernel step by step), and iLQG through the contact pipeline (the dynamics
Jacobians of `vmap(jacfwd)` at a contact state, then one iteration).

Tolerances are the suite's: 5e-4 on residual rows, 2e-4 on qpos and 2e-3 on
qvel for one kernel step from the same state, 1e-4 abs / 1e-3 rel on A and
B, 1e-3 relative on iLQG's returns and 1e-3 on its actions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.physics import forward as JF
from mujoco_mpc_tpu.planners import derivatives as JD
from mujoco_mpc_tpu.planners import ilqg as jilqg
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.planners import derivatives as TD
from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import once_a_session, pressed_state, to_np, tt

TOL_ROWS, TOL_QPOS, TOL_QVEL = 5e-4, 2e-4, 2e-3


@pytest.fixture(scope="module")
def walker():
  return jregistry.get_task("Walker"), tregistry.get_task("Walker",
                                                          device="cpu")


def test_pipeline_residual_matches_jax(walker, tmp_path_factory):
  jt, pt = walker
  jm, pm = jt.plan_model, pt.plan_model
  qpos, qvel, ctrl = pressed_state(pt, 7, qvel_scale=0.8)
  params = np.array([1.1, 0.7], np.float32)

  def jax_residual():
    jd = jt.make_data().replace(qpos=jnp.asarray(qpos),
                                qvel=jnp.asarray(qvel),
                                ctrl=jnp.asarray(ctrl))
    return {"r": np.asarray(jax.jit(lambda d: jt.residual(
        jm, JF.forward(jm, d), jnp.asarray(params)))(jd))}

  want = once_a_session(tmp_path_factory, "walker_residual",
                        jax_residual)["r"]
  d = TF.forward(pm, convert.data_from_numpy(pm, qpos=qpos, qvel=qvel,
                                             ctrl=ctrl))
  got = pt.residual(pm, d, tt(params))
  assert got.shape == (pm.nu + 3,)
  np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL_ROWS,
                             rtol=TOL_ROWS)
  assert abs(float(got[-1]) + 0.7) > 0.05      # the com moves
  assert pt.residual_names == ["residual_Height Goal",
                               "residual_Speed Goal"]


def test_lane_residual_steps_match_jax_lane_kernel(walker):
  """The rollout kernel's plain version with the Walker residual against
  JAX's lane kernel, one step at a time from the same states: K=4
  candidates on the floor (capsule ends pressed in), 3 steps; the kernel
  drops the capsule-capsule pairs on both sides (ground contacts only)."""
  jt, pt = walker
  jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  assert pspec["dim"] == jspec["dim"] == 9 and pspec["naux"] == 2
  jk = jstep.build_rollout_kernel(
      jt.plan_model, 3, 1, interpret=True, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  pk = tstep.build_rollout_kernel(pt.plan_model, 3, 1, residual=pspec,
                                  naux=pspec["naux"])
  assert pk.build_defines()["LR_NCON"] == 14        # 7 capsules x 2 ends
  k = 4
  states = [pressed_state(pt, 20 + i, depth=0.003, qvel_scale=0.3)
            for i in range(k)]
  qpos = np.stack([s[0] for s in states], axis=1)
  qvel = np.stack([s[1] for s in states], axis=1)
  ctrl = 0.3 * np.stack([s[2] for s in states], axis=1)
  aux = np.tile(to_np(pspec["make_aux"](pt.make_data(),
                                        pt.residual_params))[:, None],
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


def test_dynamics_jacobians_match_jax_at_contact_states(walker,
                                                      tmp_path_factory):
  """A and B of `vmap(jacfwd)` through the contact pipeline along 5
  states pressed into the floor (active pyramidal rows)."""
  jt, pt = walker
  jm, pm = jt.plan_model, pt.plan_model
  rows = [pressed_state(pt, 30 + i, depth=0.005, qvel_scale=0.2)
          for i in range(5)]
  s = np.stack([np.concatenate([q, v]) for q, v, _ in rows])
  u = 0.2 * np.stack([c for _, _, c in rows])
  t = (0.01 * np.arange(5)).astype(np.float32)

  def jax_jacobians():
    a, b = jax.jit(lambda s, u, t: JD.model_derivatives(
        jm, jt.make_data(), s, u, t, skip=1))(
            jnp.asarray(s), jnp.asarray(u), jnp.asarray(t))
    return dict(a=np.asarray(a), b=np.asarray(b))

  want = once_a_session(tmp_path_factory, "walker_jacobians", jax_jacobians)
  ja, jb = want["a"], want["b"]
  pa, pb = TD.model_derivatives(pm, pt.make_data(), tt(s), tt(u), tt(t),
                                skip=1)
  assert pa.shape == (5, 18, 18) and pb.shape == (5, 18, 6)
  scale = max(1.0, float(np.abs(np.asarray(ja)).max()))
  np.testing.assert_allclose(to_np(pa), np.asarray(ja), atol=1e-4 * scale,
                             rtol=1e-3)
  np.testing.assert_allclose(to_np(pb), np.asarray(jb), atol=1e-4 * scale,
                             rtol=1e-3)
  # the contact rows shape the derivatives: the same states in the air
  lifted = s.copy()
  lifted[:, 1] += 0.1
  pa_air, _ = TD.model_derivatives(pm, pt.make_data(), tt(lifted), tt(u),
                                   tt(t), skip=1)
  assert float((pa - pa_air).abs().max()) > 1e-2


def test_one_ilqg_iteration_matches_jax(walker):
  """One iteration at H=6 from a standing state, both on the pipeline
  line searches; then the port's lane route builds on Walker."""
  jt, pt = walker
  horizon = 6
  jcfg = jilqg.make_config(jt).replace(horizon=horizon, num_alphas=4,
                                       num_fb_scales=3)
  pcfg = tilqg.make_config(pt).replace(horizon=horizon, num_alphas=4,
                                       num_fb_scales=3)
  assert dataclasses.asdict(pcfg) == {k: getattr(jcfg, k)
                                      for k in dataclasses.asdict(pcfg)}
  qpos, _, _ = pressed_state(pt, 41, depth=0.002, qvel_scale=0.0)
  jd0 = jt.make_data().replace(qpos=jnp.asarray(qpos))
  pd0 = pt.make_data().replace(qpos=tt(qpos))
  jp = jilqg.ILQGPlanner(jt, jcfg, lane=False)
  jinfo = jp.optimize(jax.random.PRNGKey(0), jd0)
  pp = tilqg.ILQGPlanner(pt, pcfg, lane=False, device="cpu")
  info = pp.optimize(None, pd0)
  for key in ("nominal_return", "best_return"):
    np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                               rtol=1e-3, err_msg=key)
  assert bool(info["improved"]) == bool(jinfo["improved"])
  np.testing.assert_allclose(float(info["alpha"]), float(jinfo["alpha"]),
                             rtol=1e-6)
  np.testing.assert_allclose(to_np(pp.policy.actions),
                             np.asarray(jp.policy.actions), atol=1e-3)
  np.testing.assert_allclose(to_np(pp.policy.states),
                             np.asarray(jp.policy.states), atol=1e-3)
  lane = tilqg.ILQGPlanner(pt, pcfg, lane=True, device="cpu")
  assert lane.routes == dict(line_search="kernel", backward="plain")
  assert tstep.unsupported(pt.plan_model, ground_only=True) is None
  lane_info = lane.optimize(None, pd0)
  assert np.isfinite(float(lane_info["best_return"]))
  assert float(lane_info["best_return"]) <= float(
      lane_info["nominal_return"])
  assert torch.isfinite(lane.policy.gains).all()
