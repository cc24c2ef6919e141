"""The port's contact-free pipeline physics against the JAX package's.

Every ported function gets the Data the JAX pipeline produced up to that
stage (carried across as numpy) and must reproduce the JAX function's
output: 1e-5 on derived quantities (same float32 formulas, other summation
order), 2e-6 qpos / 5e-5 qvel on a whole step (the JAX suite's own bars
for kernel vs pipeline steps). Models: Cartpole (slide + hinge, one limited
joint, RK4) and Swimmer (fluid, limited hinges, Euler with implicit
damping), from perturbed states; on Swimmer one joint is pushed past its
limit so the Newton solve has an active row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import constraint as JC
from mujoco_mpc_tpu.physics import forward as JF
from mujoco_mpc_tpu.physics import kinematics as JK
from mujoco_mpc_tpu.physics import math as jmm
from mujoco_mpc_tpu.physics import smooth as JS
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import constraint as TC
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.physics import kinematics as TK
from mujoco_mpc_tpu_torch.physics import math as tmm
from mujoco_mpc_tpu_torch.physics import model as tmodel
from mujoco_mpc_tpu_torch.physics import smooth as TS
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

TOL = 1e-5
CASES = [("Cartpole", "model"), ("Cartpole", "plan_model"),
         ("Swimmer", "model"), ("Swimmer", "plan_model")]


def _state(name, which, seed=0):
  """(JAX model, JAX data, port model, port data) at one perturbed state."""
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  jm, pm = getattr(jt, which), getattr(pt, which)
  rng = np.random.default_rng(seed)
  d0 = jt.make_data()
  qpos = np.asarray(d0.qpos) + 0.3 * rng.standard_normal(jm.nq)
  if name == "Swimmer":
    qpos[4] = 1.8            # past the joint's upper limit (100 degrees)
  qvel = rng.standard_normal(jm.nv)
  ctrl = rng.uniform(-1.3, 1.3, jm.nu)
  f32 = jnp.float32
  jd = d0.replace(qpos=jnp.asarray(qpos, f32), qvel=jnp.asarray(qvel, f32),
                  ctrl=jnp.asarray(ctrl, f32))
  pd = convert.data_from_numpy(pm, qpos=qpos, qvel=qvel, ctrl=ctrl,
                               mocap_pos=np.asarray(d0.mocap_pos))
  return jm, jd, pm, pd


def _carry(pd, jd):
  """The port's Data with every field the JAX Data has a value for."""
  kw = {}
  for f in dataclasses.fields(tmodel.Data):
    v = getattr(jd, f.name, None)
    if v is not None:
      kw[f.name] = tt(np.asarray(v))
  return pd.replace(**kw)


def _stages(jm, jd):
  """JAX Data after each pipeline stage, in order."""
  out = {}
  jd = JK.kinematics(jm, jd); out["kinematics"] = jd
  jd = JK.com_pos(jm, jd); out["com_pos"] = jd
  jd = JS.crb(jm, jd); out["crb"] = jd
  jd = JS.factor_m(jm, jd); out["factor_m"] = jd
  jd = JC.make_constraint(jm, jd); out["make_constraint"] = jd
  jd = JK.com_vel(jm, jd); out["com_vel"] = jd
  jd = JS.rne(jm, jd); out["rne"] = jd
  jd = JS.passive(jm, jd); out["passive"] = jd
  jd = JC.reference_constraint(jm, jd); out["reference_constraint"] = jd
  jd = JS.actuation(jm, jd); out["actuation"] = jd
  jd = JF.fwd_acceleration(jm, jd); out["fwd_acceleration"] = jd
  jd = JC.solve(jm, jd); out["solve"] = jd
  return out


STAGES = [
    # stage, port function, input stage, fields compared
    ("kinematics", TK.kinematics, None,
     ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
      "site_xpos", "site_xmat")),
    ("com_pos", TK.com_pos, "kinematics", ("subtree_com", "cinert", "cdof")),
    ("crb", TS.crb, "com_pos", ("qM",)),
    ("factor_m", TS.factor_m, "crb", ("qLD",)),
    ("make_constraint", TC.make_constraint, "factor_m",
     ("efc_J", "efc_pos", "efc_solref", "efc_solimp", "efc_diag")),
    ("com_vel", TK.com_vel, "make_constraint", ("cvel", "cdof_dot")),
    ("rne", TS.rne, "com_vel", ("qfrc_bias",)),
    ("passive", TS.passive, "rne", ("qfrc_passive",)),
    ("reference_constraint", TC.reference_constraint, "passive",
     ("efc_D", "efc_aref")),
    ("actuation", TS.actuation, "reference_constraint",
     ("qfrc_actuator", "actuator_force", "actuator_length",
      "actuator_velocity", "ctrl")),
    ("fwd_acceleration", TF.fwd_acceleration, "actuation",
     ("qfrc_smooth", "qacc_smooth")),
    ("solve", TC.solve, "fwd_acceleration",
     ("qacc", "qfrc_constraint", "efc_force")),
]


@pytest.fixture(scope="module")
def staged():
  out = {}
  for name, which in CASES:
    jm, jd, pm, pd = _state(name, which)
    out[(name, which)] = (jm, jd, pm, pd, _stages(jm, jd))
  return out


@pytest.mark.parametrize("stage", [s[0] for s in STAGES])
@pytest.mark.parametrize("name,which", CASES)
def test_stage_matches_jax(staged, name, which, stage):
  jm, jd, pm, pd, jstages = staged[(name, which)]
  _, fn, before, fields = next(s for s in STAGES if s[0] == stage)
  pin = _carry(pd, jstages[before] if before else jd)
  got = fn(pm, pin)
  want = jstages[stage]
  for f in fields:
    w = np.asarray(getattr(want, f))
    scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
    if stage in ("solve", "reference_constraint"):
      scale *= 10.0    # stiff limit rows: D ~ 1e4 amplifies the last bits
    np.testing.assert_allclose(to_np(getattr(got, f)), w, atol=TOL * scale,
                               rtol=TOL, err_msg=f"{stage}.{f}")


@pytest.mark.parametrize("name,which", CASES)
def test_the_limit_rows_are_there_and_one_is_active_on_swimmer(staged, name,
                                                               which):
  jm, jd, pm, pd, jstages = staged[(name, which)]
  nlim = int(np.sum(np.asarray(pm.jnt_limited) != 0))
  assert nlim > 0 and pm.dev["lim_J"].shape == (2 * nlim, pm.nv)
  active = np.asarray(jstages["reference_constraint"].efc_D) > 0
  assert active.any() == (name == "Swimmer")


@pytest.mark.parametrize("name,which", CASES)
def test_step_matches_jax(name, which):
  jm, jd, pm, pd = _state(name, which, seed=1)
  step = jax.jit(lambda d: JF.step(jm, d))
  for t in range(3):
    jd, pd = step(jd), TF.step(pm, pd)
    np.testing.assert_allclose(to_np(pd.qpos), np.asarray(jd.qpos),
                               atol=2e-6, err_msg=f"qpos t={t}")
    np.testing.assert_allclose(to_np(pd.qvel), np.asarray(jd.qvel),
                               atol=5e-5, err_msg=f"qvel t={t}")
    np.testing.assert_allclose(float(pd.time), float(jd.time), atol=1e-6)


def test_step_is_vmappable_and_matches_the_single_step():
  pm = tregistry.get_task("Swimmer", device="cpu").plan_model
  rng = np.random.default_rng(2)
  d0 = tmodel.make_data(pm)
  qpos = d0.qpos[None] + tt(0.2 * rng.standard_normal((3, pm.nq)))
  qvel = tt(rng.standard_normal((3, pm.nv)))

  def one(q, v):
    d = TF.step(pm, d0.replace(qpos=q, qvel=v))
    return d.qpos, d.qvel

  bq, bv = torch.func.vmap(one)(qpos, qvel)
  for i in range(3):
    q, v = one(qpos[i], qvel[i])
    # batched products sum in another order; qvel carries the stiff terms
    torch.testing.assert_close(bq[i], q, atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(bv[i], v, atol=1e-4, rtol=1e-3)


def test_quaternion_helpers_match_jax():
  rng = np.random.default_rng(3)
  qa = rng.standard_normal((16, 4)); qa /= np.linalg.norm(qa, axis=1)[:, None]
  qb = rng.standard_normal((16, 4)); qb /= np.linalg.norm(qb, axis=1)[:, None]
  qb[:4] = qa[:4]                       # zero rotation
  v = rng.standard_normal((16, 3))
  pairs = [
      (tmm.mul_quat(tt(qa), tt(qb)), jmm.mul_quat(qa, qb)),
      (tmm.rot_vec_quat(tt(qa), tt(v)), jmm.rot_vec_quat(qa, v)),
      (tmm.quat_to_mat(tt(qa)), jmm.quat_to_mat(qa)),
      (tmm.quat_sub(tt(qa), tt(qb)), jmm.quat_sub(qa, qb)),
      (tmm.quat_integrate(tt(qa), tt(v), 0.01),
       jmm.quat_integrate(jnp.asarray(qa, jnp.float32),
                          jnp.asarray(v, jnp.float32), 0.01)),
      (tmm.motion_cross(tt(np.hstack([v, v[::-1]])),
                        tt(np.hstack([v[::-1], v]))),
       jmm.motion_cross(np.hstack([v, v[::-1]]), np.hstack([v[::-1], v]))),
  ]
  for got, want in pairs:
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL)
  # forward-mode derivative at zero rotation is finite (identity map)
  jac = torch.func.jacfwd(lambda q: tmm.quat_sub(q, tt(qa[0])))(tt(qa[0]))
  assert torch.isfinite(jac).all()


def test_models_outside_the_ported_subset_are_refused_by_name():
  quad = tregistry.get_task("Quadruped Flat", device="cpu")
  with pytest.raises(NotImplementedError, match="contacts"):
    TF.step(quad.model, quad.make_data())
  cart = tregistry.get_task("Cartpole", device="cpu").model
  for change, word in [
      (dict(opt=cart.opt.replace(integrator=tmodel.IMPLICIT)), "integrator"),
      (dict(neq=1), "equality"), (dict(ntendon=2), "tendons"),
      (dict(na=1), "activation"),
      (dict(opt=cart.opt.replace(noslip_iterations=3)), "noslip"),
      (dict(actuator_gaintype=np.array([tmodel.GAIN_MUSCLE])), "muscle"),
      (dict(actuator_trntype=np.array([tmodel.TRN_SITE])), "transmissions"),
  ]:
    bad = cart.replace(**change)
    assert any(word in w for w in TF.unsupported(bad)), (word,
                                                         TF.unsupported(bad))
    with pytest.raises(NotImplementedError, match=word):
      TF.forward(bad, tmodel.make_data(cart))
  assert TF.unsupported(cart) == []
