"""Shared helpers for the tests of the PyTorch port (test_torch_*.py).

The same inputs, made with numpy, go through the JAX function and its
counterpart in the port (on the CPU, i.e. the plain versions of the
kernels); results come back as numpy arrays.
"""

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
