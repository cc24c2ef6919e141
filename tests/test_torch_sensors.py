"""The port's sensor evaluation (physics/sensors.py make_sensor_fn, built
from the model's sensor table) against the JAX package's (built from the
MjModel), from the same states: Cartpole's record, and the inline IMU,
force/torque, touch and rangefinder models of tests/test_sensors.py, each
carried into the port by convert.py. Also the sensor table of the
committed Cartpole record, and the build-time refusals.

Tolerances are no looser than tests/test_sensors.py's own against MuJoCo
(magnetometer 1e-6, frame position 1e-4, velocities 1e-3, accelerations
and force/torque 5e-3, rangefinder 2e-3); here, both sides running the
same algorithm from the same state, most are tighter (TOL below). The JAX
side runs eagerly.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import forward as JF
from mujoco_mpc_tpu.physics import model as jmodel
from mujoco_mpc_tpu.physics import sensors as jsensors
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.physics import sensors as tsensors
from mujoco_mpc_tpu_torch.tasks import base as tbase
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.test_sensors import IMU_PENDULUM, TOUCH_SPHERE
from tests.torch_port_helpers import models_from_xml, to_np, tt

# per sensor name: (atol, rtol)
TOL = {"acc": (5e-4, 1e-4), "gyr": (1e-5, 1e-5), "vel": (1e-5, 1e-5),
       "mag": (1e-6, 0.0), "linacc": (5e-4, 1e-4), "angacc": (5e-4, 1e-4),
       "fp": (1e-5, 0.0), "flv": (1e-5, 1e-5), "frc": (5e-4, 1e-4),
       "trq": (5e-4, 1e-4), "touch": (5e-3, 1e-3), "range": (1e-4, 0.0)}

# the digest of every field the committed Cartpole record held before it
# carried a sensor table (its arrays and the rest of its tree)
CARTPOLE_OLD_FIELDS = \
    "fae19b4430f1f44214d90659695598a1d54ba006f36287b0e030af77c13c4721"


def _slices(mjm):
  return {mjm.sensor(i).name: slice(int(mjm.sensor_adr[i]),
                                    int(mjm.sensor_adr[i] + mjm.sensor_dim[i]))
          for i in range(mjm.nsensor)}


def _both(jm, pm, mjm, qpos, qvel, ctrl=None):
  """(JAX reading, port reading) after a full forward pass of each side's
  own physics from the same state."""
  jd = jmodel.make_data(jm).replace(qpos=jnp.asarray(qpos, jnp.float32),
                                   qvel=jnp.asarray(qvel, jnp.float32))
  pd = convert.data_from_numpy(pm, qpos=qpos, qvel=qvel)
  if ctrl is not None:
    jd = jd.replace(ctrl=jnp.asarray(ctrl, jnp.float32))
    pd = pd.replace(ctrl=tt(ctrl))
  with jax.disable_jit():
    want = np.asarray(jsensors.make_sensor_fn(mjm)(jm, JF.forward(jm, jd)))
  fn = tsensors.make_sensor_fn(pm)
  got = to_np(fn(pm, TF.forward(pm, pd)))
  return want, got, fn


def test_sensor_enum_values_are_mujocos():
  for name, value in tsensors.SENSOR_TYPES.items():
    assert int(getattr(mujoco.mjtSensor, "mjSENS_" + name.upper())) == \
        value, name
  for name, value in tsensors.OBJ_TYPES.items():
    assert int(getattr(mujoco.mjtObj, "mjOBJ_" + name.upper())) == value


def test_cartpole_record_carries_the_sensor_table():
  """The committed record's table equals MuJoCo's arrays (the exporter's
  output), and every field the record held before is unchanged."""
  jt = jregistry.get_task("Cartpole")
  mjm = jt.mjm
  path = os.path.join(tbase.ASSET_DIR, "cartpole.npz")
  with np.load(path, allow_pickle=False) as z:
    record = convert.record_from_npz(z)
    tree = json.loads(str(z["__tree__"]))
    for k in ("model", "plan_model"):
      tree[k].pop("sensors")
      tree[k]["opt"].pop("magnetic")
    h = hashlib.sha256(json.dumps(tree, sort_keys=True).encode())
    for k in sorted(z.files):
      if k == "__tree__" or "/sensors/" in k or k.endswith("/opt/magnetic"):
        continue
      a = z[k]
      h.update(f"{k}|{a.dtype.str}|{a.shape}".encode())
      h.update(np.ascontiguousarray(a).tobytes())
  assert h.hexdigest() == CARTPOLE_OLD_FIELDS
  for which in ("model", "plan_model"):
    table = record[which]["sensors"]
    for mine, theirs in (("type", "sensor_type"), ("objtype",
                                                   "sensor_objtype"),
                         ("objid", "sensor_objid"), ("dim", "sensor_dim"),
                         ("adr", "sensor_adr"), ("site_type", "site_type")):
      np.testing.assert_array_equal(table[mine], getattr(mjm, theirs),
                                    err_msg=mine)
    np.testing.assert_array_equal(table["site_size"], mjm.site_size)
    np.testing.assert_array_equal(record[which]["opt"]["magnetic"],
                                  np.asarray(mjm.opt.magnetic, np.float32))
  pm = tregistry.get_task("Cartpole", device="cpu").model
  assert pm.sensors.nsensor == mjm.nsensor == 7


def test_cartpole_sensors_match_jax():
  """jointpos x2 and a site framepos (the four user sensors skipped) at
  random moving states."""
  jt = jregistry.get_task("Cartpole")
  pt = tregistry.get_task("Cartpole", device="cpu")
  rng = np.random.default_rng(0)
  for _ in range(3):
    qpos = rng.uniform(-1, 1, 2) * np.array([0.5, np.pi])
    qvel = rng.standard_normal(2)
    want, got, fn = _both(jt.model, pt.model, jt.mjm, qpos, qvel,
                          ctrl=rng.uniform(-1, 1, 1))
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, atol=TOL["fp"][0])
    np.testing.assert_allclose(got[:2], qpos, atol=1e-6)
  assert fn.skipped == [] and fn.needs_acc is False


def test_imu_and_force_torque_sensors_match_jax():
  """Contact-free pendulum: accelerometer, gyro, velocimeter,
  magnetometer, frame acceleration, force and torque (the acceleration
  stage: mj_rnePostConstraint) at random states under a damped swing."""
  jm, pm, mjm = models_from_xml(IMU_PENDULUM)
  sl = _slices(mjm)
  rng = np.random.default_rng(1)
  for _ in range(2):
    want, got, fn = _both(jm, pm, mjm, rng.uniform(-2, 2, 1),
                          2 * rng.standard_normal(1))
    assert fn.needs_acc
    for name, (atol, rtol) in TOL.items():
      if name in sl:
        np.testing.assert_allclose(got[sl[name]], want[sl[name]], atol=atol,
                                   rtol=rtol, err_msg=name)
    assert np.abs(want[sl["acc"]]).max() > 1.0      # not trivially zero


def test_touch_and_rangefinder_match_jax():
  """A free ball pressed into the floor (an active pyramidal contact):
  the touch sensor's normal force and the downward rangefinder; in the
  air the touch reads zero and the range the height."""
  jm, pm, mjm = models_from_xml(TOUCH_SPHERE)
  sl = _slices(mjm)
  for z, vz in ((0.049, -0.1), (0.0495, 0.0), (0.3, 0.5)):
    qpos = np.array([0.01, -0.02, z, 1.0, 0.0, 0.0, 0.0])
    qvel = np.array([0.05, 0.0, vz, 0.1, -0.2, 0.0])
    want, got, _ = _both(jm, pm, mjm, qpos, qvel)
    for name in ("touch", "range"):
      atol, rtol = TOL[name]
      np.testing.assert_allclose(got[sl[name]], want[sl[name]], atol=atol,
                                 rtol=rtol, err_msg=f"{name} z={z}")
    if z < 0.05:
      assert want[sl["touch"]][0] > 0.5
    else:
      assert want[sl["touch"]][0] == got[sl["touch"]][0] == 0.0
    np.testing.assert_allclose(got[sl["range"]], [z], atol=1e-5)


TENDON = """
<mujoco>
  <worldbody>
    <body name="b1" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0"/>
      <geom type="sphere" size="0.05" mass="0.1"/>
    </body>
  </worldbody>
  <tendon><fixed name="t"><joint joint="j1" coef="1"/></fixed></tendon>
  <sensor>{sensor}</sensor>
</mujoco>
"""

DISTANCE = """
<mujoco>
  <worldbody>
    <body name="b1" pos="0 0 1"><joint type="hinge" axis="0 1 0"/>
      <geom name="g1" type="sphere" size="0.05" mass="0.1"/></body>
    <body name="b2" pos="0.3 0 1"><joint type="hinge" axis="0 1 0"/>
      <geom name="g2" type="sphere" size="0.05" mass="0.1"/></body>
  </worldbody>
  <sensor><distance name="dist" geom1="g1" geom2="g2"/></sensor>
</mujoco>
"""


@pytest.mark.parametrize("kind", ["tendonpos", "tendonvel"])
def test_tendon_sensors_raise_by_name(kind):
  _, pm, _ = models_from_xml(TENDON.format(
      sensor=f'<{kind} name="s" tendon="t"/>'))
  with pytest.raises(NotImplementedError, match=f"'s' is a {kind}.*tendon"):
    tsensors.make_sensor_fn(pm)


def test_unsupported_sensor_type_raises_unless_skipped():
  _, pm, mjm = models_from_xml(DISTANCE)
  with pytest.raises(ValueError, match="'dist' has unsupported type"):
    tsensors.make_sensor_fn(pm)
  stype = int(mjm.sensor_type[0])
  fn = tsensors.make_sensor_fn(pm, skip_types=(stype,))
  assert fn.skipped == [(0, stype)]
  d = TF.forward(pm, convert.data_from_numpy(pm))
  np.testing.assert_array_equal(to_np(fn(pm, d)), np.zeros(1))


def test_sensor_fn_is_vmappable():
  """The UKF steps its sigma points through one vmap of the sensor
  evaluation: the vmapped reading equals the per-state one."""
  jm, pm, mjm = models_from_xml(IMU_PENDULUM)
  fn = tsensors.make_sensor_fn(pm)
  rng = np.random.default_rng(2)
  qpos, qvel = tt(rng.uniform(-1, 1, (3, 1))), tt(rng.standard_normal((3, 1)))
  d0 = convert.data_from_numpy(pm)

  def read(q, v):
    return fn(pm, TF.forward(pm, d0.replace(qpos=q, qvel=v)))

  batched = torch.func.vmap(read)(qpos, qvel)
  for i in range(3):
    np.testing.assert_allclose(to_np(batched[i]),
                               to_np(read(qpos[i], qvel[i])), atol=1e-6,
                               rtol=1e-5)
