"""Model / Data records.

`Model` holds a compiled MuJoCo model restricted to what the ported paths
read (the lane rollout kernel and its planners, the contact-free pipeline
physics): tree-structure tables stay host-side numpy arrays (they drive
static loops and fill the kernel's constant tables), numeric parameters
are float32 tensors on the chosen device. Field names
are those of the JAX package's physics/model.py so a reader finds the
counterpart. Building a Model straight from an `MjModel` (`put_model`)
arrives in a later slice; for now a Model comes from a dictionary of numpy
arrays (`Model.from_numpy`, see convert.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

# Joint types (match mjtJoint values)
FREE = 0
BALL = 1
SLIDE = 2
HINGE = 3

# Geom types (match mjtGeom values)
GEOM_PLANE = 0
GEOM_HFIELD = 1
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_ELLIPSOID = 4
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

# Integrators (match mjtIntegrator values)
EULER = 0
RK4 = 1
IMPLICIT = 2
IMPLICITFAST = 3

# Actuator dynamics / gain / bias / transmission types
DYN_NONE = 0
GAIN_FIXED = 0
GAIN_AFFINE = 1
GAIN_MUSCLE = 2
BIAS_NONE = 0
BIAS_AFFINE = 1
BIAS_MUSCLE = 2
TRN_JOINT = 0
TRN_SITE = 4

# Friction cones
CONE_PYRAMIDAL = 0
CONE_ELLIPTIC = 1


def check_device(device) -> torch.device:
  """The torch device for `device`; raises if it is CUDA and there is no
  card — entry points never carry on silently on the CPU."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "device='cuda' was requested but no CUDA device is available; "
        "pass device='cpu' explicitly to run the plain versions")
  return device


@dataclasses.dataclass(frozen=True)
class PairGroup:
  """All candidate pairs sharing one (type1, type2) narrowphase function."""
  types: tuple        # (type1, type2)
  geom1: np.ndarray   # (npair,)
  geom2: np.ndarray   # (npair,)
  ncon_per_pair: int

  @property
  def count(self) -> int:
    return len(self.geom1)


@dataclasses.dataclass(frozen=True)
class CollisionPairs:
  groups: tuple       # tuple[PairGroup, ...]
  ncon: int           # total candidate contact count (static)
  # per-candidate-contact static solver params (ncon rows)
  con_condim: Optional[np.ndarray] = None
  con_friction: Optional[np.ndarray] = None       # (ncon, 5)
  con_solref: Optional[np.ndarray] = None         # (ncon, 2)
  con_solimp: Optional[np.ndarray] = None         # (ncon, 5)
  con_includemargin: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class Option:
  timestep: torch.Tensor
  gravity: torch.Tensor
  wind: torch.Tensor
  density: torch.Tensor
  viscosity: torch.Tensor
  impratio: torch.Tensor
  cone: int = CONE_PYRAMIDAL
  iterations: int = 6
  ls_iterations: int = 4
  integrator: int = EULER
  noslip_iterations: int = 0
  disableflags: int = 0

  def replace(self, **kw) -> "Option":
    return dataclasses.replace(self, **kw)


OPTION_TENSORS = ("timestep", "gravity", "wind", "density", "viscosity",
                  "impratio")
OPTION_STATIC = ("cone", "iterations", "ls_iterations", "integrator",
                 "noslip_iterations", "disableflags")

MODEL_SIZES = ("nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite",
               "nmocap", "nuserdata", "neq", "ntendon")
MODEL_TABLES = (
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_mocapid", "jnt_type",
    "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
    "dof_bodyid", "dof_jntid", "dof_ancestor_mask", "body_dof_mask",
    "geom_type", "geom_bodyid", "site_bodyid", "actuator_trntype",
    "actuator_trnid", "actuator_gaintype", "actuator_biastype",
    "actuator_ctrllimited", "actuator_forcelimited", "actuator_dyntype",
    "subtree_mask", "dof_pred_mask", "dof_cdofdot_zero")
MODEL_TENSORS = (
    "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_subtreemass", "body_inertia",
    "body_invweight0", "jnt_pos", "jnt_axis", "jnt_range",
    "jnt_stiffness", "jnt_solref", "jnt_solimp", "jnt_margin",
    "dof_damping", "dof_armature", "dof_frictionloss", "dof_invweight0",
    "geom_pos", "geom_quat", "geom_size", "site_pos", "site_quat",
    "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange",
    "actuator_forcerange", "actuator_gear")


def fluid_box(body_mass, body_inertia) -> np.ndarray:
  """Equivalent inertia-box sizes per body (nbody, 3) of the fluid model,
  from the masses and the principal moments: host arithmetic on model
  constants, shared by the pipeline physics and the lane kernel's tables."""
  mass = np.maximum(np.asarray(body_mass, np.float64), 1e-15)
  i0, i1, i2 = (np.asarray(body_inertia, np.float64)[:, k] for k in range(3))
  return np.stack([
      np.sqrt(np.maximum(1e-12, (i1 + i2 - i0) * 3.0 / (2.0 * mass))),
      np.sqrt(np.maximum(1e-12, (i0 + i2 - i1) * 3.0 / (2.0 * mass))),
      np.sqrt(np.maximum(1e-12, (i0 + i1 - i2) * 3.0 / (2.0 * mass))),
  ], axis=-1)


DEVICE_MASKS = ("subtree_mask", "body_dof_mask", "dof_pred_mask",
                "dof_cdofdot_zero", "dof_ancestor_mask")
DEVICE_INDICES = ("body_rootid", "site_bodyid", "dof_bodyid", "dof_jntid")


def _device_tables(kw: dict, fields: dict, dev, device) -> dict:
  """The `Model.dev` constants from the host tables `kw` and the numeric
  fields; `dev` maps a numpy value to a float32 tensor on `device`."""
  tables = {k: dev(kw[k]) for k in DEVICE_MASKS}
  tables.update({k: torch.as_tensor(
      np.array(kw[k], dtype=np.int64)).to(device) for k in DEVICE_INDICES})
  flags = dict(
      ctrllimited=kw["actuator_ctrllimited"] != 0,
      forcelimited=kw["actuator_forcelimited"] != 0,
      gain_fixed=kw["actuator_gaintype"] == GAIN_FIXED,
      bias_none=kw["actuator_biastype"] == BIAS_NONE)
  tables.update({k: torch.as_tensor(np.array(v, dtype=bool)).to(device)
                 for k, v in flags.items()})
  # joint transmissions: constant moment matrix; the length of a scalar
  # joint's actuator is gear0 * qpos[trn_qadr] (zero for free / ball)
  nu, nv = kw["nu"], kw["nv"]
  moment = np.zeros((nu, nv), np.float32)
  trn_qadr = np.zeros((nu,), np.int64)
  len_gear = np.zeros((nu,), np.float32)
  gear = np.asarray(fields["actuator_gear"], np.float32).reshape(nu, 6)
  for u in range(nu):
    if int(kw["actuator_trntype"][u]) != TRN_JOINT:
      continue
    tid = int(kw["actuator_trnid"][u, 0])
    jtype, dadr = int(kw["jnt_type"][tid]), int(kw["jnt_dofadr"][tid])
    if jtype in (HINGE, SLIDE):
      moment[u, dadr] = gear[u, 0]
      trn_qadr[u] = int(kw["jnt_qposadr"][tid])
      len_gear[u] = gear[u, 0]
    else:
      ndof = 6 if jtype == FREE else 3
      moment[u, dadr:dadr + ndof] = gear[u, :ndof]
  # joint-limit rows, two per limited hinge/slide joint (lower, upper)
  lim = [j for j in range(kw["njnt"]) if kw["jnt_limited"][j]
         and int(kw["jnt_type"][j]) in (HINGE, SLIDE)]
  nrow = 2 * len(lim)
  lim_j = np.zeros((nrow, nv), np.float32)
  lim_cols = {k: [] for k in ("qadr", "sign", "range", "margin", "solref",
                              "solimp", "diag")}
  for r, (j, side) in enumerate((j, s) for j in lim for s in (0, 1)):
    dadr = int(kw["jnt_dofadr"][j])
    sign = 1.0 if side == 0 else -1.0
    lim_j[r, dadr] = sign
    lim_cols["qadr"].append(int(kw["jnt_qposadr"][j]))
    lim_cols["sign"].append(sign)
    lim_cols["range"].append(fields["jnt_range"][j][side])
    lim_cols["margin"].append(fields["jnt_margin"][j])
    lim_cols["solref"].append(fields["jnt_solref"][j])
    lim_cols["solimp"].append(fields["jnt_solimp"][j])
    lim_cols["diag"].append(fields["dof_invweight0"][dadr])
  tables["lim_J"] = dev(lim_j)
  tables["lim_qadr"] = torch.as_tensor(
      np.array(lim_cols["qadr"], dtype=np.int64)).to(device)
  for k, width in (("sign", ()), ("range", ()), ("margin", ()),
                   ("solref", (2,)), ("solimp", (5,)), ("diag", ())):
    tables["lim_" + k] = dev(
        np.array(lim_cols[k], np.float32).reshape((nrow,) + width))
  tables["trn_moment"] = dev(moment)
  tables["trn_len_gear"] = dev(len_gear)
  tables["trn_qadr"] = torch.as_tensor(trn_qadr).to(device)
  tables["has_damping"] = bool(np.any(np.asarray(
      fields["dof_damping"]) > 0))
  tables["has_frictionloss"] = bool(np.any(np.asarray(
      fields["dof_frictionloss"]) > 0))
  not_world = np.ones((kw["nbody"], 1), np.float32)
  not_world[0] = 0.0
  tables["not_world"] = dev(not_world)
  tables["fluid_box"] = dev(fluid_box(fields["body_mass"],
                                      fields["body_inertia"]))
  return tables


@dataclasses.dataclass(frozen=True)
class Model:
  """Static model description: sizes, host-side tables, device params."""
  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nmocap: int
  nuserdata: int
  neq: int
  ntendon: int
  # tree / index tables (host numpy)
  body_parentid: np.ndarray
  body_rootid: np.ndarray
  body_jntadr: np.ndarray
  body_jntnum: np.ndarray
  body_dofadr: np.ndarray
  body_dofnum: np.ndarray
  body_mocapid: np.ndarray
  jnt_type: np.ndarray
  jnt_qposadr: np.ndarray
  jnt_dofadr: np.ndarray
  jnt_bodyid: np.ndarray
  jnt_limited: np.ndarray
  dof_bodyid: np.ndarray
  dof_jntid: np.ndarray
  dof_ancestor_mask: np.ndarray   # (nv, nv): dof j is ancestor-or-self of i
  body_dof_mask: np.ndarray       # (nbody, nv): dof moves the body
  geom_type: np.ndarray
  geom_bodyid: np.ndarray
  site_bodyid: np.ndarray
  actuator_trntype: np.ndarray
  actuator_trnid: np.ndarray
  actuator_gaintype: np.ndarray
  actuator_biastype: np.ndarray
  actuator_ctrllimited: np.ndarray
  actuator_forcelimited: np.ndarray
  actuator_dyntype: np.ndarray
  subtree_mask: np.ndarray        # (nbody, nbody): c in the subtree of b
  dof_pred_mask: np.ndarray       # (nv, nv): dofs in the pre-velocity of j
  dof_cdofdot_zero: np.ndarray    # (nv,): cdof_dot identically zero
  # numeric parameters (float32 tensors)
  qpos0: torch.Tensor
  qpos_spring: torch.Tensor
  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  body_subtreemass: torch.Tensor
  body_inertia: torch.Tensor
  body_invweight0: torch.Tensor
  jnt_pos: torch.Tensor
  jnt_axis: torch.Tensor
  jnt_range: torch.Tensor
  jnt_stiffness: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor
  jnt_margin: torch.Tensor
  dof_damping: torch.Tensor
  dof_armature: torch.Tensor
  dof_frictionloss: torch.Tensor
  dof_invweight0: torch.Tensor
  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  geom_size: torch.Tensor
  site_pos: torch.Tensor
  site_quat: torch.Tensor
  actuator_gainprm: torch.Tensor
  actuator_biasprm: torch.Tensor
  actuator_ctrlrange: torch.Tensor
  actuator_forcerange: torch.Tensor
  actuator_gear: torch.Tensor
  opt: Option = None
  collision_pairs: Any = None
  names: Any = None
  # device-side constants the pipeline physics uses in tensor ops: float32
  # copies of the mask tables (DEVICE_MASKS), int64 index vectors
  # (DEVICE_INDICES), boolean actuator flags, `not_world` (nbody, 1) and the
  # fluid model's `fluid_box` (nbody, 3), the joint transmissions' constant
  # moment matrix `trn_moment` (nu, nv) with `trn_qadr` / `trn_len_gear`,
  # the joint-limit rows' constants `lim_*` (two rows per limited joint),
  # and two host booleans `has_damping` / `has_frictionloss`
  dev: Any = None
  # how the pipeline physics solves its SPD systems (physics/smooth.py
  # spd_solve): "library" (the library Cholesky, differentiable: the
  # derivative sweep) or "kernel" (the batched Cholesky kernel
  # ops/cholesky.py, set by the batched rollouts of rollout.py)
  solve_route: str = "library"

  def replace(self, **kw) -> "Model":
    return dataclasses.replace(self, **kw)

  @classmethod
  def from_numpy(cls, fields: dict, device="cuda") -> "Model":
    """Build from a dictionary of numpy values keyed by field name, with
    `opt` a sub-dictionary of Option fields, `collision_pairs` a
    sub-dictionary (`ncon`, `con_*`, `groups`: list of {types, geom1,
    geom2, ncon_per_pair}) or None, and `names` a dictionary of name
    lists. Raises when `device` is unavailable."""
    def dev(x):
      return torch.as_tensor(np.array(x, dtype=np.float32)).to(device)

    kw = {k: int(fields[k]) for k in MODEL_SIZES}
    kw.update({k: np.asarray(fields[k]) for k in MODEL_TABLES})
    kw.update({k: dev(fields[k]) for k in MODEL_TENSORS})
    o = fields["opt"]
    opt = Option(**{k: dev(o[k]) for k in OPTION_TENSORS},
                 **{k: int(o[k]) for k in OPTION_STATIC})
    cp = fields.get("collision_pairs")
    pairs = None
    if cp is not None:
      groups = tuple(
          PairGroup(types=tuple(int(t) for t in g["types"]),
                    geom1=np.asarray(g["geom1"]),
                    geom2=np.asarray(g["geom2"]),
                    ncon_per_pair=int(g["ncon_per_pair"]))
          for g in cp["groups"])
      pairs = CollisionPairs(
          groups=groups, ncon=int(cp["ncon"]),
          **{k: np.asarray(cp[k]) for k in (
              "con_condim", "con_friction", "con_solref", "con_solimp",
              "con_includemargin")})
    names = {k: list(v) for k, v in (fields.get("names") or {}).items()}
    tables = _device_tables(kw, fields, dev, device)
    return cls(opt=opt, collision_pairs=pairs, names=names, dev=tables,
               **kw)


@dataclasses.dataclass(frozen=True)
class Data:
  """Dynamic state, and the quantities the pipeline physics derives from it
  (None until the stage that computes them has run)."""
  qpos: torch.Tensor
  qvel: torch.Tensor
  time: torch.Tensor
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor
  userdata: torch.Tensor
  act: torch.Tensor = None
  ctrl: torch.Tensor = None
  qfrc_applied: torch.Tensor = None
  xfrc_applied: torch.Tensor = None   # (nbody, 6) world wrench at body com
  # position-dependent
  xpos: torch.Tensor = None
  xquat: torch.Tensor = None
  xmat: torch.Tensor = None
  xipos: torch.Tensor = None
  ximat: torch.Tensor = None
  xanchor: torch.Tensor = None
  xaxis: torch.Tensor = None
  site_xpos: torch.Tensor = None
  site_xmat: torch.Tensor = None
  subtree_com: torch.Tensor = None
  cinert: torch.Tensor = None         # (nbody, 10)
  cdof: torch.Tensor = None           # (nv, 6)
  qM: torch.Tensor = None
  qLD: torch.Tensor = None            # Cholesky factor of qM
  # velocity-dependent
  cvel: torch.Tensor = None           # (nbody, 6)
  cdof_dot: torch.Tensor = None       # (nv, 6)
  qfrc_bias: torch.Tensor = None
  qfrc_passive: torch.Tensor = None
  qfrc_actuator: torch.Tensor = None
  actuator_force: torch.Tensor = None
  actuator_length: torch.Tensor = None
  actuator_velocity: torch.Tensor = None
  act_dot: torch.Tensor = None
  qfrc_smooth: torch.Tensor = None
  qacc_smooth: torch.Tensor = None
  # constraint rows (joint limits)
  efc_J: torch.Tensor = None
  efc_pos: torch.Tensor = None
  efc_solref: torch.Tensor = None
  efc_solimp: torch.Tensor = None
  efc_diag: torch.Tensor = None
  efc_D: torch.Tensor = None
  efc_aref: torch.Tensor = None
  efc_force: torch.Tensor = None
  qfrc_constraint: torch.Tensor = None
  qacc: torch.Tensor = None

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)


def make_data(m: Model, device=None) -> Data:
  """Fresh Data at qpos0, zero velocity; mocap bodies start at their model
  body pose. Lives on the model's device unless `device` is given."""
  device = m.qpos0.device if device is None else device
  mocap_pos = np.zeros((max(m.nmocap, 1), 3), np.float32)
  mocap_quat = np.tile(np.array([1.0, 0, 0, 0], np.float32),
                       (max(m.nmocap, 1), 1))
  body_pos = m.body_pos.cpu().numpy()
  body_quat = m.body_quat.cpu().numpy()
  for b in range(m.nbody):
    mid = int(m.body_mocapid[b])
    if mid >= 0:
      mocap_pos[mid] = body_pos[b]
      mocap_quat[mid] = body_quat[b]
  f32 = dict(dtype=torch.float32, device=device)
  return Data(
      qpos=m.qpos0.to(device).clone(),
      qvel=torch.zeros((m.nv,), **f32),
      time=torch.zeros((), **f32),
      mocap_pos=torch.as_tensor(mocap_pos).to(device),
      mocap_quat=torch.as_tensor(mocap_quat).to(device),
      userdata=torch.zeros((max(m.nuserdata, 1),), **f32),
      act=torch.zeros((m.na,), **f32),
      ctrl=torch.zeros((m.nu,), **f32),
      qfrc_applied=torch.zeros((m.nv,), **f32),
      xfrc_applied=torch.zeros((m.nbody, 6), **f32))
