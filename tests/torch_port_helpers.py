"""Shared helpers for the tests of the PyTorch port (test_torch_*.py).

The same inputs, made with numpy, go through the JAX function and its
counterpart in the port (on the CPU, i.e. the plain versions of the
kernels); results come back as numpy arrays.
"""

import os

import filelock
import numpy as np
import torch

from mujoco_mpc_tpu_torch import convert

# The tensors here are tiny; one thread per test process keeps the port's
# tests from crowding the other workers' cores.
torch.set_num_threads(1)


# same model as tests/test_lane_elliptic.py, with the floor's condim open
BALL = """
<mujoco model="eball">
  <option timestep="0.002" gravity="0 0 -9.81" cone="{cone}"
          impratio="{impratio}" iterations="30" ls_iterations="25"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" condim="{floor_condim}"/>
    <body name="ball" pos="0 0 0.5">
      <freejoint/>
      <geom name="ball_geom" type="sphere" size="0.1" mass="0.5"
            condim="{condim}" friction="1.2 0.01 0.005"/>
    </body>
  </worldbody>
</mujoco>
"""

LIMITED = """
<mujoco model="limited">
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="cart" pos="0 0 1">
      <joint name="slide" type="slide" axis="1 0 0" range="-0.5 0.5"
             limited="true" damping="0.05"/>
      <geom type="box" size="0.1 0.1 0.05" mass="1.0" contype="0"
            conaffinity="0"/>
      <body name="pole" pos="0 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" range="-30 40"
               limited="true" damping="0.01" armature="0.01"/>
        <geom type="capsule" fromto="0 0 0 0 0 0.5" size="0.02" mass="0.2"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="slide" kp="20" ctrlrange="-1 1" ctrllimited="true"
              forcerange="-5 5" forcelimited="true"/>
    <motor joint="hinge" gear="3"/>
  </actuator>
</mujoco>
"""


# Two elliptic contacts of different condim and different support: a free
# ball (condim 6, six dofs) and a hinged arm whose sphere tip rests on the
# floor (condim 3, one dof).
MIXED_CONTACTS = """
<mujoco model="mixed">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic" impratio="3"
          iterations="30" ls_iterations="25"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" condim="3"/>
    <body name="ball" pos="0 0 0.1">
      <freejoint/>
      <geom name="ball_geom" type="sphere" size="0.1" mass="0.5" condim="6"
            friction="1.2 0.01 0.005"/>
    </body>
    <body name="arm" pos="1 0 0.3">
      <joint name="arm_hinge" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom name="arm_link" type="capsule" fromto="0 0 0 0.4 0 0" size="0.02"
            mass="0.3" contype="0" conaffinity="0"/>
      <geom name="arm_tip" type="sphere" pos="0.4 0 0" size="0.05" mass="0.1"
            condim="3" friction="0.9 0.01 0.001"/>
    </body>
  </worldbody>
</mujoco>
"""


# a free body on the floor, given one ground geom (DROP_GEOMS): off-axis,
# so that the body-local contact points go through geom_quat
DROP = """
<mujoco model="drop">
  <option timestep="0.002" gravity="0 0 -9.81" cone="{cone}"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="body" pos="0 0 0.5">
      <freejoint/>
      {geom}
    </body>
  </worldbody>
</mujoco>
"""
DROP_GEOMS = {
    "capsule": '<geom type="capsule" fromto="-0.15 0 0 0.15 0.05 0.02" '
               'size="0.04" mass="0.6" friction="0.9 0.01 0.001"/>',
    "box": '<geom type="box" size="0.08 0.05 0.03" euler="10 20 30" '
           'pos="0.01 0 0" mass="0.7"/>',
}


def once_a_session(tmp_path_factory, name, compute):
  """compute() -> dict of numpy arrays, computed once a test session.

  Under pytest-xdist each worker builds a module fixture for itself, so a
  fixture shared by tests that land on several workers is computed once a
  worker. Here the first worker to ask computes it, under a file lock in
  the session's base temporary directory (shared by its workers), and
  saves it there; the others wait on the lock and load the file. Without
  xdist it is computed in the process."""
  if os.environ.get("PYTEST_XDIST_WORKER") is None:
    return compute()
  path = tmp_path_factory.getbasetemp().parent / f"{name}.npz"
  with filelock.FileLock(f"{path}.lock"):
    if not path.is_file():
      data = compute()
      tmp = path.parent / f"{name}.{os.getpid()}.tmp.npz"
      np.savez(tmp, **data)
      os.replace(tmp, path)
      return data
  with np.load(path) as f:
    return {k: f[k] for k in f.files}


def to_np(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def tt(x) -> torch.Tensor:
  return torch.as_tensor(np.array(x, dtype=np.float32))


def models_from_xml(xml: str):
  """(JAX Model, port Model on the CPU, MjModel) of one MJCF string."""
  import mujoco
  from mujoco_mpc_tpu.physics import model as jax_model
  mjm = mujoco.MjModel.from_xml_string(xml)
  jm = jax_model.put_model(mjm)
  pm = convert.model_from_jax_numpy(convert.model_fields(jm), device="cpu")
  return jm, pm, mjm


def riccati_problem(horizon, ndx, nu, seed, tight_limits):
  """One random iLQG backward-sweep problem as float32 numpy arrays (a, b,
  cx, cu, cxx, cxu, cuu, lo, hi): near-identity dynamics, SPD cost
  Hessians, control limits loose (5.0) or tight (0.05) — the generator of
  tests/test_riccati_lane.py."""
  rng = np.random.default_rng(seed)
  f = np.float32
  t = horizon
  a = (np.eye(ndx) + 0.05 * rng.standard_normal((t - 1, ndx, ndx))).astype(f)
  b = (0.1 * rng.standard_normal((t - 1, ndx, nu))).astype(f)
  cx = (0.3 * rng.standard_normal((t, ndx))).astype(f)
  cu = (0.3 * rng.standard_normal((t, nu))).astype(f)
  w = rng.standard_normal((t, ndx, ndx))
  cxx = (np.einsum("tij,tkj->tik", w, w) / ndx + 0.5 * np.eye(ndx)).astype(f)
  cxu = (0.05 * rng.standard_normal((t, ndx, nu))).astype(f)
  wu = rng.standard_normal((t, nu, nu))
  cuu = (np.einsum("tij,tkj->tik", wu, wu) / nu + 0.5 * np.eye(nu)).astype(f)
  lim = 0.05 if tight_limits else 5.0
  lo = np.full((t - 1, nu), -lim, f)
  hi = np.full((t - 1, nu), lim, f)
  return a, b, cx, cu, cxx, cxu, cuu, lo, hi


def clearances(pm, qpos) -> np.ndarray:
  """(K,) lowest clearance of the rollout kernel's ground contact points
  for each column of qpos (numpy)."""
  from mujoco_mpc_tpu_torch.ops import step_lane
  return np.array([step_lane.contact_clearance(pm, tt(qpos[:, k]))
                   for k in range(qpos.shape[1])])


# Two bodies in contact, one geom each: a hinged arm (geom1 side, its geom
# at x=0.2 in the arm frame, the arm's hinge at z=0.3) and a free body
# (PAIR_GEOMS). `pair_states` puts the free body at a set of distances
# from the arm's geom (separated, touching, pressed in; for a point in a
# box also its centre inside the box).
PAIR = """
<mujoco model="pair">
  <option timestep="0.002" gravity="0 0 -9.81" cone="{cone}"
          impratio="{impratio}"/>
  <default><geom condim="{condim}" friction="1.1 0.01 0.005"/></default>
  <worldbody>
    <body name="arm" pos="0 0 0.3">
      <joint name="arm_hinge" type="hinge" axis="0 1 0" damping="0.05"/>
      {geom_a}
    </body>
    <body name="free" pos="0.2 0 0.5">
      <freejoint/>
      {geom_b}
    </body>
  </worldbody>
</mujoco>
"""
_ARM_BOX = '<geom type="box" pos="0.2 0 0" size="0.05 0.04 0.03" mass="0.4"/>'
_ARM_CAPSULE = ('<geom type="capsule" fromto="0.1 0 0 0.3 0 0" size="0.03" '
                'mass="0.3"/>')
# pair type -> (arm geom, free geom, free body's quaternion, the free body's
# centre (x, y) and the height above the arm's axis at which it touches)
PAIR_GEOMS = {
    "sphere_sphere": (
        '<geom type="sphere" pos="0.2 0 0" size="0.05" mass="0.3"/>',
        '<geom type="sphere" size="0.04" mass="0.2"/>', (1, 0, 0, 0),
        (0.22, 0.01), float(np.sqrt(0.09 ** 2 - 0.02 ** 2 - 0.01 ** 2))),
    "sphere_capsule": (
        _ARM_CAPSULE, '<geom type="sphere" size="0.04" mass="0.2"/>',
        (1, 0, 0, 0), (0.25, 0.015),
        float(np.sqrt(0.07 ** 2 - 0.015 ** 2))),
    "capsule_capsule": (
        _ARM_CAPSULE, '<geom type="capsule" fromto="0 -0.08 0 0 0.08 0" '
        'size="0.025" mass="0.2"/>',
        (np.cos(0.175), 0, 0, np.sin(0.175)), (0.22, 0.01), 0.055),
    "sphere_box": (
        _ARM_BOX, '<geom type="sphere" size="0.02" mass="0.2"/>',
        (1, 0, 0, 0), (0.21, 0.01), 0.05),
    "capsule_box": (
        _ARM_BOX, '<geom type="capsule" fromto="-0.04 0 0 0.04 0 0" '
        'size="0.015" mass="0.2"/>',
        (np.cos(0.0436), 0, np.sin(0.0436), 0), (0.2, 0.005),
        0.03 + 0.015 + 0.04 * np.sin(0.0872)),
    "box_box": (
        _ARM_BOX, '<geom type="box" size="0.02 0.025 0.02" mass="0.2"/>',
        (np.cos(0.1), np.sin(0.1) * 0.6, np.sin(0.1) * 0.8, 0),
        (0.205, 0.005), None),
}


def pair_xml(kind: str, cone: str = "pyramidal", condim: int = 3,
             impratio: float = 1.0) -> str:
  geom_a, geom_b = PAIR_GEOMS[kind][:2]
  return PAIR.format(cone=cone, impratio=impratio, condim=condim,
                     geom_a=geom_a, geom_b=geom_b)


def _quat_rotate(q, v):
  w, x, y, z = q
  r = np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
  return r @ np.asarray(v, np.float64)


def pair_states(kind: str, nv: int, rng, depths=(-0.003, 0.0005, 0.001,
                                                  0.002, 0.003)):
  """(qpos (8, K), qvel (nv, K)) float64: the arm at angle 0 (its geom's
  top face, or axis, at z=0.3), the free body above it at each depth of
  `depths` (a point in a box also with its centre 5 mm inside), a small
  random tilt of the arm, random velocities, the free body moving down at
  about 0.2 m/s."""
  _, _, quat, (x, y), touch = PAIR_GEOMS[kind]
  quat = np.asarray(quat, np.float64)
  quat /= np.linalg.norm(quat)
  if touch is None:
    # a box on the arm's box: its lowest corner on the top face
    corners = [_quat_rotate(quat, [sx * 0.02, sy * 0.025, sz * 0.02])
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    touch = 0.03 - min(c[2] for c in corners)
  depths = list(depths)
  if kind == "sphere_box":
    depths.append(0.025)         # the centre 5 mm inside the box
  k = len(depths)
  qpos = np.zeros((8, k))
  qpos[0] = rng.uniform(-0.002, 0.002, k)
  qpos[1], qpos[2] = x, y
  qpos[3] = 0.3 + touch - np.asarray(depths)
  qpos[4:] = quat[:, None]
  qvel = 0.05 * rng.standard_normal((nv, k))
  qvel[3] -= 0.2                 # the free body moving down into the arm
  return qpos, qvel
