"""State carried across from the JAX package as plain numpy.

The port never imports the JAX package; whatever crosses over does so as
numpy arrays. `model_fields` reads the fields the port's Model keeps from
any object that has them as attributes (a JAX Model, a test double);
`model_from_jax_numpy` builds the port's Model from such a dictionary.
`task_record` / `record_to_npz` / `record_from_npz` define the
compiled-task snapshot stored under assets/ — numeric arrays plus one JSON
string for everything that is not an array — which `tasks.base.Task`
loads without needing `mujoco` at run time.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mujoco_mpc_tpu_torch import spline as spline_lib
from mujoco_mpc_tpu_torch.costs.spec import CostSpec
from mujoco_mpc_tpu_torch.physics import model as model_lib

_CP_ARRAYS = ("con_condim", "con_friction", "con_solref", "con_solimp",
              "con_includemargin")


def model_fields(m) -> dict:
  """Dictionary of numpy values for every field the port's Model keeps,
  read by attribute from a model-like object."""
  out = {k: int(getattr(m, k)) for k in model_lib.MODEL_SIZES}
  for k in model_lib.MODEL_TABLES:
    out[k] = np.asarray(getattr(m, k))
  for k in model_lib.MODEL_TENSORS:
    out[k] = np.asarray(getattr(m, k), dtype=np.float32)
  out["opt"] = {k: np.asarray(getattr(m.opt, k), dtype=np.float32)
                for k in model_lib.OPTION_TENSORS}
  out["opt"].update({k: int(getattr(m.opt, k))
                     for k in model_lib.OPTION_STATIC})
  cp = m.collision_pairs
  if cp is None:
    out["collision_pairs"] = None
  else:
    out["collision_pairs"] = {
        "ncon": int(cp.ncon),
        "groups": [dict(types=[int(t) for t in g.types],
                        geom1=np.asarray(g.geom1), geom2=np.asarray(g.geom2),
                        ncon_per_pair=int(g.ncon_per_pair))
                   for g in cp.groups]}
    for k in _CP_ARRAYS:
      v = getattr(cp, k)
      out["collision_pairs"][k] = (
          np.zeros((0,), np.float32) if v is None else np.asarray(v))
  out["names"] = {k: list(v) for k, v in (m.names or {}).items()}
  return out


def model_from_jax_numpy(fields: dict, device="cuda") -> model_lib.Model:
  return model_lib.Model.from_numpy(fields, device=device)


def cost_spec_fields(spec) -> dict:
  return dict(term_names=list(spec.term_names),
              norm_types=[int(t) for t in spec.norm_types],
              dims=[int(d) for d in spec.dims],
              weights=np.asarray(spec.weights, dtype=np.float32),
              norm_params=np.asarray(spec.norm_params, dtype=np.float32),
              risk=np.asarray(spec.risk, dtype=np.float32))


def cost_spec_from_numpy(fields: dict, device="cuda") -> CostSpec:
  def dev(x):
    return torch.as_tensor(np.array(x, dtype=np.float32)).to(device)
  return CostSpec(
      term_names=tuple(fields["term_names"]),
      norm_types=tuple(int(t) for t in fields["norm_types"]),
      dims=tuple(int(d) for d in fields["dims"]),
      weights=dev(fields["weights"]),
      norm_params=dev(fields["norm_params"]).reshape(-1, 3),
      risk=dev(fields["risk"]))


def policy_from_numpy(t0, dt, values, interp=spline_lib.Interpolation.ZERO,
                      device="cuda") -> spline_lib.SplinePolicy:
  def dev(x):
    return torch.as_tensor(np.array(x, dtype=np.float32)).to(device)
  return spline_lib.SplinePolicy(t0=dev(t0), dt=dev(dt), values=dev(values),
                                 interp=int(interp))


def data_from_numpy(m: model_lib.Model, qpos=None, qvel=None, time=None,
                    mocap_pos=None, mocap_quat=None, userdata=None,
                    act=None, ctrl=None, qfrc_applied=None,
                    xfrc_applied=None, device=None) -> model_lib.Data:
  """Data on the model's device with the given fields overridden."""
  d = model_lib.make_data(m, device=device)
  dev = d.qpos.device
  given = dict(qpos=qpos, qvel=qvel, time=time, mocap_pos=mocap_pos,
               mocap_quat=mocap_quat, userdata=userdata, act=act, ctrl=ctrl,
               qfrc_applied=qfrc_applied, xfrc_applied=xfrc_applied)
  kw = {k: torch.as_tensor(np.array(v, dtype=np.float32)).to(dev)
        for k, v in given.items() if v is not None}
  return d.replace(**kw)


def ilqg_policy_from_numpy(states, actions, times, gains, reg, reg_rate,
                           device="cuda"):
  """The port's ILQGPolicy from the leaves of a JAX ILQGPolicy given as
  numpy arrays."""
  from mujoco_mpc_tpu_torch.planners import ilqg as ilqg_lib

  def dev(x):
    return torch.as_tensor(np.array(x, dtype=np.float32)).to(device)
  return ilqg_lib.ILQGPolicy(
      states=dev(states), actions=dev(actions), times=dev(times),
      gains=dev(gains), reg=dev(reg), reg_rate=dev(reg_rate))


# ---- compiled-task records ------------------------------------------------


def task_record(name: str, model: dict, plan_model: dict, cost_spec: dict,
                residual_params, numerics: dict, keyframes: dict,
                texts: dict, residual_names=()) -> dict:
  """Nested record of one compiled task: `model` / `plan_model` as from
  `model_fields`, `cost_spec` as from `cost_spec_fields`, the XML
  residual parameters and the names of their `residual_*` numerics in
  MjModel order (entry i names residual_params[i]; the numerics dict is
  stored with its keys sorted), the first value of every custom numeric,
  keyframe qpos by name, and the custom texts."""
  return dict(
      name=name, model=model, plan_model=plan_model, cost_spec=cost_spec,
      residual_params=np.asarray(residual_params, dtype=np.float32),
      residual_names=[str(n) for n in residual_names],
      numerics={k: float(v) for k, v in numerics.items()},
      keyframes={k: np.asarray(v, dtype=np.float64)
                 for k, v in keyframes.items()},
      texts=dict(texts))


def _flatten(node, prefix, arrays):
  """Arrays go to `arrays` by path; everything else into the JSON tree."""
  if isinstance(node, dict):
    return {k: _flatten(v, f"{prefix}/{k}" if prefix else str(k), arrays)
            for k, v in node.items()}
  if isinstance(node, np.ndarray):
    arrays[prefix] = node
    return {"__array__": prefix}
  if isinstance(node, (list, tuple)) and node and isinstance(node[0], dict):
    return [_flatten(v, f"{prefix}/{i}", arrays)
            for i, v in enumerate(node)]
  if isinstance(node, (np.integer, np.floating)):
    return node.item()
  return node


def _unflatten(node, arrays):
  if isinstance(node, dict):
    if set(node) == {"__array__"}:
      return arrays[node["__array__"]]
    return {k: _unflatten(v, arrays) for k, v in node.items()}
  if isinstance(node, list):
    return [_unflatten(v, arrays) for v in node]
  return node


def record_to_npz(record: dict) -> dict:
  """Flat {key: ndarray} form of a record, ready for `np.savez`."""
  arrays = {}
  tree = _flatten(record, "", arrays)
  arrays["__tree__"] = np.asarray(json.dumps(tree, sort_keys=True))
  return arrays


def record_from_npz(arrays) -> dict:
  """Inverse of `record_to_npz`; `arrays` is a mapping such as the object
  `np.load` returns."""
  tree = json.loads(str(arrays["__tree__"]))
  return _unflatten(tree, arrays)
