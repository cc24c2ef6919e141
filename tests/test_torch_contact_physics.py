"""The port's pipeline physics with contacts (pyramidal rows from the
primitive narrowphase) against the JAX package's and C MuJoCo.

Walker's plan model: 26 candidate contacts (7 plane-capsule pairs, 2 points
each; 12 capsule-capsule pairs), condim 3, pyramidal cones, 6 limited
joints. The rows (J, pos, gate, diag, D, aref), the solved forces and
qacc against JAX's `forward` from poses pressed into the floor; the
top-k selection of the deepest contacts when the candidates outnumber
`max_contact_points`; 4 steps against JAX `step` (2e-4 on qpos, 2e-3 on
qvel, the suite's bars) and against C MuJoCo's `mj_step` (its own solver,
100 iterations against 6: ~2e-3); the gate of physics/forward.py.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import forward as JF
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.agent import agent as tagent
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import (models_from_xml, once_a_session,
                                      pressed_state, to_np)

TOL_QPOS, TOL_QVEL = 2e-4, 2e-3
ROWS = ("efc_J", "efc_pos", "efc_gate", "efc_diag", "efc_D", "efc_aref")


@pytest.fixture(scope="module")
def walker():
  return jregistry.get_task("Walker"), tregistry.get_task("Walker",
                                                          device="cpu")


def _jax_data(jt, qpos, qvel, ctrl):
  return jt.make_data().replace(qpos=jnp.asarray(qpos),
                                qvel=jnp.asarray(qvel),
                                ctrl=jnp.asarray(ctrl))


CONTACT_FLOAT = ("dist", "pos", "frame", "friction", "force")
CONTACT_INT = ("geom1_id", "geom2_id", "body1", "body2", "dim")
TOP_K = 6


def _forward_cases(pt):
  """(name, max_contact_points or None, (qpos, qvel, ctrl)) of the forward
  comparisons: two pressed poses, and the top-k pose."""
  return [(f"seed{seed}", None,
           pressed_state(pt, seed, depth=0.006, qvel_scale=0.05))
          for seed in (1, 2)] + [
              ("top_k", TOP_K, pressed_state(pt, 5, qvel_scale=0.05))]


def _jax_forwards(jt, pt):
  """JAX `forward` at every case, one jitted function a model (the plan
  model, and the plan model keeping TOP_K contacts): the fields compared,
  as numpy arrays keyed "<case>/<field>"."""
  out = {}
  fns = {}
  for name, k, (qpos, qvel, ctrl) in _forward_cases(pt):
    if k not in fns:
      jm = jt.plan_model
      if k is not None:
        jm = jm.replace(opt=jm.opt.replace(max_contact_points=k))
      fns[k] = jax.jit(lambda d, jm=jm: JF.forward(jm, d))
    want = fns[k](_jax_data(jt, qpos, qvel, ctrl))
    for f in ROWS + ("efc_force", "qfrc_constraint", "qacc"):
      out[f"{name}/{f}"] = np.asarray(getattr(want, f))
    for f in CONTACT_FLOAT + CONTACT_INT:
      out[f"{name}/contact.{f}"] = np.asarray(getattr(want.contact, f))
  return out


def _compare_forward(tmp_path_factory, jt, pt, case):
  """The port's forward against JAX's at one case of `_forward_cases`; the
  JAX forwards are computed once a session."""
  jax_out = once_a_session(tmp_path_factory, "contact_physics_forward",
                           lambda: _jax_forwards(jt, pt))
  (_, k, (qpos, qvel, ctrl)), = [c for c in _forward_cases(pt)
                                 if c[0] == case]
  pm = pt.plan_model
  if k is not None:
    pm = pm.replace(opt=pm.opt.replace(max_contact_points=k))
  got = TF.forward(pm, convert.data_from_numpy(pm, qpos=qpos, qvel=qvel,
                                               ctrl=ctrl))
  for f in ROWS:
    w = jax_out[f"{case}/{f}"]
    np.testing.assert_allclose(to_np(getattr(got, f)), w, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(w).max()),
                               err_msg=f)
  np.testing.assert_allclose(to_np(got.efc_eq), 0.0)
  for f in ("efc_force", "qfrc_constraint", "qacc"):
    w = jax_out[f"{case}/{f}"]
    np.testing.assert_allclose(to_np(getattr(got, f)), w, rtol=2e-3,
                               atol=2e-3 * max(1.0, np.abs(w).max()),
                               err_msg=f)
  for f in CONTACT_FLOAT:
    w = jax_out[f"{case}/contact.{f}"]
    np.testing.assert_allclose(to_np(getattr(got.contact, f)), w, rtol=2e-3,
                               atol=2e-3 * max(1.0, np.abs(w).max()),
                               err_msg=f"contact.{f}")
  for f in CONTACT_INT:
    np.testing.assert_array_equal(to_np(getattr(got.contact, f)),
                                  jax_out[f"{case}/contact.{f}"])
  return got


@pytest.mark.parametrize("seed", [1, 2])
def test_walker_contact_rows_match_jax(walker, seed, tmp_path_factory):
  jt, pt = walker
  pm = pt.plan_model
  assert (pm.nq, pm.nv, pm.nu, pm.collision_pairs.ncon) == (9, 9, 6, 26)
  got = _compare_forward(tmp_path_factory, jt, pt, f"seed{seed}")
  assert got.efc_J.shape == (12 + 4 * 26, 9)   # limits, then contacts
  active = to_np(got.efc_gate) < 0
  assert active[12:].sum() >= 4 and to_np(got.contact.force)[:, 0].max() > 0


def test_top_k_keeps_the_deepest_contacts(walker, tmp_path_factory):
  """6 of the 26 candidates kept: the deepest, sorted by depth. Walker's
  symmetric legs give some pairs equal gaps whatever the joint angles
  (two implementations may order those differently), so the pose is one
  whose 7 smallest gaps are all distinct."""
  jt, pt = walker
  k = TOP_K
  qpos, qvel, ctrl = pressed_state(pt, 5, qvel_scale=0.05)
  full = TF.forward(pt.plan_model, convert.data_from_numpy(
      pt.plan_model, qpos=qpos, qvel=qvel, ctrl=ctrl))
  smallest = np.sort(to_np(full.contact.dist))[:k + 1]
  assert len(np.unique(smallest)) == k + 1, smallest
  got = _compare_forward(tmp_path_factory, jt, pt, "top_k")
  assert got.efc_J.shape == (12 + 4 * k, 9)
  np.testing.assert_array_equal(to_np(got.contact.dist), smallest[:k])


def _jax_steps(jt, qpos, qvel, ctrl, n):
  """The JAX plan model's states over n steps from (qpos, qvel) under
  ctrl: qpos (n + 1, nq), qvel (n + 1, nv)."""
  jm = jt.plan_model
  jd = _jax_data(jt, qpos, qvel, ctrl)
  step = jax.jit(lambda d: JF.step(jm, d))
  qs, vs = [np.asarray(jd.qpos)], [np.asarray(jd.qvel)]
  for _ in range(n):
    jd = step(jd)
    qs.append(np.asarray(jd.qpos))
    vs.append(np.asarray(jd.qvel))
  return dict(qpos=np.array(qs), qvel=np.array(vs))


def test_walker_steps_match_jax(walker, tmp_path_factory):
  jt, pt = walker
  pm = pt.plan_model
  qpos, qvel, ctrl = pressed_state(pt, 3, depth=0.01, qvel_scale=0.05)
  ctrl = 0.1 * ctrl          # full torques lift the foot off at once
  first = TF.forward(pm, convert.data_from_numpy(pm, qpos=qpos, qvel=qvel,
                                                 ctrl=ctrl))
  assert to_np(first.contact.force)[:, 0].max() > 0   # the floor pushes
  want = once_a_session(tmp_path_factory, "contact_physics_steps",
                        lambda: _jax_steps(jt, qpos, qvel, ctrl, 4))
  for t in range(4):
    pd = convert.data_from_numpy(pm, qpos=want["qpos"][t],
                                 qvel=want["qvel"][t], ctrl=ctrl)
    pd = TF.step(pm, pd)
    np.testing.assert_allclose(to_np(pd.qpos), want["qpos"][t + 1],
                               atol=TOL_QPOS, err_msg=f"qpos t={t}")
    np.testing.assert_allclose(to_np(pd.qvel), want["qvel"][t + 1],
                               atol=TOL_QVEL, err_msg=f"qvel t={t}")


def test_walker_steps_track_mujoco(walker):
  """The simulation model (0.005 s) from a pressed state, 5 steps of the
  port against `mj_step` (MuJoCo's own solver at its own iterations)."""
  jt, pt = walker
  mjm = jt.mjm
  m = pt.model
  qpos, qvel, ctrl = pressed_state(pt, 4, depth=0.003, qvel_scale=0.2)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos, qvel, ctrl
  d = convert.data_from_numpy(m, qpos=qpos, qvel=qvel, ctrl=ctrl)
  contacts = []
  for _ in range(5):
    mujoco.mj_step(mjm, mjd)
    contacts.append(mjd.ncon)
    d = TF.step(m, d)
  assert contacts[0] > 0, contacts
  np.testing.assert_allclose(to_np(d.qpos), mjd.qpos, rtol=2e-3, atol=2e-3)
  np.testing.assert_allclose(to_np(d.qvel), mjd.qvel, rtol=2e-3, atol=2e-3)


HFIELD = """
<mujoco model="hfield">
  <asset><hfield name="h" nrow="3" ncol="3" size="1 1 0.1 0.1"
    elevation="0 0 0 0 1 0 0 0 0"/></asset>
  <worldbody>
    <geom type="hfield" hfield="h"/>
    <body pos="0 0 0.5"><freejoint/><geom type="sphere" size="0.1"/></body>
  </worldbody>
</mujoco>
"""
MESH = """
<mujoco model="mesh">
  <asset><mesh name="tet" vertex="0 0 0  0.1 0 0  0 0.1 0  0 0 0.1"/></asset>
  <worldbody>
    <geom type="plane" size="1 1 0.1"/>
    <body pos="0 0 0.5"><freejoint/><geom type="mesh" mesh="tet"/></body>
  </worldbody>
</mujoco>
"""
LOSSY = """
<mujoco model="lossy">
  <worldbody>
    <geom type="plane" size="1 1 0.1"/>
    <body pos="0 0 0.5">
      <joint type="slide" axis="0 0 1" frictionloss="0.3"/>
      <geom type="sphere" size="0.1"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.mark.parametrize("xml,words", [
    (HFIELD, ("height-field", "hfield-sphere")),
    (MESH, ("height-field / mesh", "plane-mesh")),
    (LOSSY, ("friction loss",)),
])
def test_gate_names_what_the_pipeline_lacks(xml, words):
  _, pm, _ = models_from_xml(xml)
  missing = "; ".join(TF.unsupported(pm))
  for word in words:
    assert word in missing, missing
  with pytest.raises(NotImplementedError, match=words[0]):
    TF.forward(pm, convert.data_from_numpy(pm))


def test_gate_accepts_walker_and_names_elliptic_cones(walker):
  _, pt = walker
  assert TF.unsupported(pt.plan_model) == TF.unsupported(pt.model) == []
  quad = tregistry.get_task("Quadruped Flat", device="cpu").plan_model
  assert any("elliptic" in w and "item 4" in w for w in TF.unsupported(quad))
  with pytest.raises(NotImplementedError, match="elliptic"):
    TF.step(quad, convert.data_from_numpy(quad))


def test_agent_steps_walker(walker):
  """Agent.step_env steps Walker's simulation model (contacts), under a
  given action: the torso falls toward the floor from its start."""
  _, pt = walker
  agent = tagent.Agent(pt, planner="iLQG", device="cpu")
  z0 = float(agent.data.qpos[1])
  for _ in range(3):
    agent.step_env(action=np.zeros(pt.model.nu, np.float32))
  assert float(agent.data.qpos[1]) < z0
  assert torch.isfinite(agent.data.qpos).all()
  np.testing.assert_allclose(float(agent.data.time),
                             3 * float(pt.model.opt.timestep), rtol=1e-6)
