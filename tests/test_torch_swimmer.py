"""The Swimmer task of the port against the JAX package's: residuals, the
lane step with fluid forces, the host transition.

Tolerances: 1e-5 on residuals (same formulas); 2e-6 qpos / 5e-5 qvel for
the lane step against the pipeline step, the bars of tests/test_ops.py for
the same comparison inside the JAX package; 2e-4 / 5e-4 port lane step vs
JAX lane step (states / residual rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.physics import forward as JF
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt


@pytest.fixture(scope="module")
def tasks():
  return (jregistry.get_task("Swimmer"),
          tregistry.get_task("Swimmer", device="cpu"))


def test_swimmer_is_in_the_lane_kernel_class_with_its_fluid(tasks):
  jt, pt = tasks
  m = pt.plan_model
  assert float(m.opt.viscosity) > 0 and float(m.opt.density) > 0
  assert tstep.supports(m, ground_only=True)
  spec = pt.lane_residual_spec()
  kern = tstep.build_rollout_kernel(m, 4, 1, residual=spec,
                                    naux=spec["naux"], feedback=True)
  defs = kern.build_defines()
  assert defs["LR_FLUID"] == 1 and defs["LR_CTRL"] == 1
  assert defs["RESIDUAL_HEADER"] == "residual_swimmer.cuh"
  assert defs["LR_NLIMJ"] == 5         # the five limited link joints
  cfg = tilqg.make_config(pt)
  assert (cfg.horizon, cfg.num_alphas, cfg.num_fb_scales, cfg.boxqp_iters,
          cfg.reg_type) == (201, 8, 4, 6, tilqg.REG_CONTROL)


def test_lane_step_with_fluid_matches_jax_lane_and_pipeline(tasks):
  jt, pt = tasks
  jm, pm = jt.plan_model, pt.plan_model
  jspec, pspec = jt.lane_residual_spec(), pt.lane_residual_spec()
  jk = jstep.build_rollout_kernel(
      jm, 3, 2, interpret=True, contact_types=(), residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  pk = tstep.build_rollout_kernel(pm, 3, 2, residual=pspec,
                                  naux=pspec["naux"])
  jstep_fn = jax.jit(jk.step_array)
  rng = np.random.default_rng(23)
  k_c = 3
  d0 = jt.make_data()
  qp = (np.tile(np.asarray(d0.qpos)[:, None], (1, k_c)) +
        0.1 * rng.standard_normal((jm.nq, k_c))).astype(np.float32)
  qv = (0.3 * rng.standard_normal((jm.nv, k_c))).astype(np.float32)
  ctrl = rng.uniform(-0.5, 0.5, (jm.nu, k_c)).astype(np.float32)
  aux = np.tile(np.asarray(jspec["make_aux"](d0, jt.residual_params))[:, None],
                (1, k_c)).astype(np.float32)
  pd0 = pt.make_data()
  for t in range(3):
    jq, jv, jr = jstep_fn(jnp.asarray(qp), jnp.asarray(qv),
                          jnp.asarray(ctrl), jnp.asarray(t, jnp.int32),
                          jnp.asarray(aux))
    pq, pv, pr = pk.step_array(tt(qp), tt(qv), tt(ctrl), t, tt(aux))
    np.testing.assert_allclose(to_np(pq), np.asarray(jq), atol=2e-4)
    np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=2e-4)
    np.testing.assert_allclose(to_np(pr), np.asarray(jr), atol=5e-4)
    for k in range(k_c):
      d = TF.step(pm, pd0.replace(qpos=tt(qp[:, k]), qvel=tt(qv[:, k]),
                                  ctrl=tt(ctrl[:, k])))
      np.testing.assert_allclose(to_np(pq[:, k]), to_np(d.qpos), atol=2e-6,
                                 err_msg=f"qpos t={t} k={k}")
      np.testing.assert_allclose(to_np(pv[:, k]), to_np(d.qvel), atol=5e-5,
                                 err_msg=f"qvel t={t} k={k}")
    qp, qv = to_np(pq), to_np(pv)


def test_pipeline_and_lane_residuals_match_jax(tasks):
  jt, pt = tasks
  jm, pm = jt.plan_model, pt.plan_model
  rng = np.random.default_rng(3)
  d0 = jt.make_data()
  qpos = np.asarray(d0.qpos) + 0.2 * rng.standard_normal(jm.nq)
  ctrl = rng.uniform(-1.5, 1.5, jm.nu)
  jd = jax.jit(lambda d: JF.forward(jm, d))(
      d0.replace(qpos=jnp.asarray(qpos, jnp.float32),
                 ctrl=jnp.asarray(ctrl, jnp.float32)))
  pd = TF.forward(pm, convert.data_from_numpy(
      pm, qpos=qpos, ctrl=ctrl, mocap_pos=np.asarray(d0.mocap_pos)))
  want = np.asarray(jt.residual(jm, jd, jt.residual_params))
  got = pt.residual(pm, pd, pt.residual_params)
  assert got.shape == (7,)
  np.testing.assert_allclose(to_np(got), want, atol=1e-5)
  np.testing.assert_allclose(want[:5], np.clip(ctrl, -1, 1), atol=1e-6)
  spec = pt.lane_residual_spec()
  kern = tstep.build_rollout_kernel(pm, 2, 1, residual=spec,
                                    naux=spec["naux"])
  rows = kern.residual_array(
      tt(qpos)[:, None], torch.zeros(pm.nv, 1),
      tt(np.clip(ctrl, -1, 1))[:, None], 0,
      spec["make_aux"](pd, pt.residual_params)[:, None])
  np.testing.assert_allclose(to_np(rows[:, 0]), want, atol=1e-5)


def test_transition_teleports_the_target_from_the_callers_generator(tasks):
  _, pt = tasks
  pm = pt.plan_model
  d = TF.forward(pm, pt.make_data())
  far = pt.transition(d, np.random.default_rng(0))
  assert far is d                                  # nose far from target
  near = d.replace(mocap_pos=torch.cat(
      [d.xpos[1, :2] + 0.01, d.mocap_pos[0, 2:]])[None])
  moved = pt.transition(near, np.random.default_rng(0))
  want = np.random.default_rng(0).uniform(-0.8, 0.8, size=2)
  np.testing.assert_allclose(to_np(moved.mocap_pos[0, :2]), want, atol=1e-6)
  assert float(moved.mocap_pos[0, 2]) == float(d.mocap_pos[0, 2])
  again = pt.transition(near, np.random.default_rng(0))
  assert torch.equal(again.mocap_pos, moved.mocap_pos)
