"""Model / Data records for the lane rollout path.

`Model` holds a compiled MuJoCo model restricted to what the lane rollout
kernel and its planner read: tree-structure tables stay host-side numpy
arrays (they drive static loops and fill the kernel's constant tables),
numeric parameters are float32 tensors on the chosen device. Field names
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

# Actuator gain / bias / transmission types
GAIN_FIXED = 0
GAIN_AFFINE = 1
BIAS_NONE = 0
BIAS_AFFINE = 1
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

  def replace(self, **kw) -> "Option":
    return dataclasses.replace(self, **kw)


OPTION_TENSORS = ("timestep", "gravity", "wind", "density", "viscosity",
                  "impratio")
OPTION_STATIC = ("cone", "iterations", "ls_iterations")

MODEL_SIZES = ("nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite",
               "nmocap", "nuserdata", "neq")
MODEL_TABLES = (
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_mocapid", "jnt_type",
    "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
    "dof_bodyid", "dof_jntid", "dof_ancestor_mask", "body_dof_mask",
    "geom_type", "geom_bodyid", "site_bodyid", "actuator_trntype",
    "actuator_trnid", "actuator_gaintype", "actuator_biastype",
    "actuator_ctrllimited", "actuator_forcelimited")
MODEL_TENSORS = (
    "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_subtreemass", "body_inertia",
    "body_invweight0", "jnt_pos", "jnt_axis", "jnt_range",
    "jnt_stiffness", "jnt_solref", "jnt_solimp", "jnt_margin",
    "dof_damping", "dof_armature", "dof_frictionloss", "dof_invweight0",
    "geom_pos", "geom_quat", "geom_size", "site_pos", "site_quat",
    "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange",
    "actuator_forcerange", "actuator_gear")


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
    return cls(opt=opt, collision_pairs=pairs, names=names, **kw)


@dataclasses.dataclass(frozen=True)
class Data:
  """Dynamic state the lane planner reads."""
  qpos: torch.Tensor
  qvel: torch.Tensor
  time: torch.Tensor
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor
  userdata: torch.Tensor

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
      userdata=torch.zeros((max(m.nuserdata, 1),), **f32))
