"""Export compiled-task records for the PyTorch port.

The port (`mujoco_mpc_tpu_torch`) runs without `mujoco`: each task it
supports is loaded from a record under `mujoco_mpc_tpu_torch/assets/`
holding the simulation and planning models (the fields the port keeps),
the collision-pair records, the cost spec, the residual parameters, the
keyframes and the custom numerics/texts. This script compiles the tasks
with the JAX package (which uses `mujoco` as the MJCF compiler) and writes
those records:

    JAX_PLATFORMS=cpu python scripts/export_torch_assets.py

`build_record(name)` returns the record without writing it;
tests/test_torch_model_convert.py holds the committed files equal to it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

ASSETS = {
    "Quadruped Flat": "quadruped_flat.npz",
    "Cartpole": "cartpole.npz",
    "Swimmer": "swimmer.npz",
    "Humanoid Stand": "humanoid_stand.npz",
    "Humanoid Walk": "humanoid_walk.npz",
    "Humanoid Track": "humanoid_track.npz",
    "Quadrotor": "quadrotor.npz",
    "Rubik": "rubik.npz",
    "Cube Solving": "cube_solving.npz",
    "Hand Reorient": "hand_reorient.npz",
}


def _text_items(mjm) -> dict:
  out = {}
  names = bytes(mjm.names)
  for i in range(mjm.ntext):
    nadr = int(mjm.name_textadr[i])
    name = names[nadr:names.index(b"\x00", nadr)].decode()
    adr, size = int(mjm.text_adr[i]), int(mjm.text_size[i])
    out[name] = bytes(mjm.text_data[adr:adr + size]).rstrip(b"\x00").decode()
  return out


def build_record(name: str) -> dict:
  """Compile task `name` with the JAX package and return its record."""
  from mujoco_mpc_tpu.costs import spec as jax_spec
  from mujoco_mpc_tpu.tasks import registry
  from mujoco_mpc_tpu_torch import convert

  # a fresh base-class parse: subclasses may append state to the params
  task = registry.get_task(name)
  mjm = task.mjm
  numerics = {mjm.numeric(i).name: float(mjm.numeric_data[mjm.numeric_adr[i]])
              for i in range(mjm.nnumeric)}
  keyframes = {mjm.key(k).name: np.array(mjm.key_qpos[k])
               for k in range(mjm.nkey)}
  return convert.task_record(
      name=name,
      model=convert.model_fields(task.model),
      plan_model=convert.model_fields(task.plan_model),
      cost_spec=convert.cost_spec_fields(jax_spec.parse_cost_spec(mjm)),
      residual_params=np.asarray(jax_spec.parse_residual_params(mjm)),
      numerics=numerics, keyframes=keyframes, texts=_text_items(mjm))


def main():
  from mujoco_mpc_tpu_torch import convert
  from mujoco_mpc_tpu_torch.tasks import base
  for name, fname in ASSETS.items():
    path = os.path.join(base.ASSET_DIR, fname)
    np.savez_compressed(path, **convert.record_to_npz(build_record(name)))
    print(f"{name}: {os.path.normpath(path)} "
          f"({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
  main()
