"""Port vs JAX: the Model the port builds, the compiled-task records under
assets/, and the port's import hygiene."""

import dataclasses
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import model as jmodel
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import model as tmodel
from mujoco_mpc_tpu_torch.tasks import base as tbase
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
TASKS = ["Quadruped Flat", "Cartpole", "Swimmer", "Humanoid Stand",
         "Humanoid Walk", "Humanoid Track", "Quadrotor", "Rubik",
         "Cube Solving", "Hand Reorient"]


def _exporter():
  spec = importlib.util.spec_from_file_location(
      "export_torch_assets",
      os.path.join(ROOT, "scripts", "export_torch_assets.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _assert_tree_equal(a, b, path=""):
  if isinstance(a, dict):
    assert isinstance(b, dict) and sorted(a) == sorted(b), path
    for k in a:
      _assert_tree_equal(a[k], b[k], f"{path}/{k}")
  elif isinstance(a, (list, tuple)) and a and isinstance(a[0], dict):
    assert len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
      _assert_tree_equal(x, y, f"{path}/{i}")
  elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
    assert np.asarray(a).dtype == np.asarray(b).dtype, path
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
  else:
    assert a == b, (path, a, b)


@pytest.mark.parametrize("name", TASKS)
@pytest.mark.parametrize("which", ["model", "plan_model"])
def test_every_ported_model_field_equals_jax(name, which):
  jm = getattr(jregistry.get_task(name), which)
  pm = getattr(tregistry.get_task(name, device="cpu"), which)
  for f in dataclasses.fields(tmodel.Model):
    if f.name in ("opt", "collision_pairs", "names", "dev", "solve_route"):
      continue
    want = np.asarray(getattr(jm, f.name))
    got = getattr(pm, f.name)
    if isinstance(got, torch.Tensor):
      assert got.dtype == torch.float32, f.name
    np.testing.assert_array_equal(to_np(got), want, err_msg=f.name)
  for f in dataclasses.fields(tmodel.Option):
    np.testing.assert_array_equal(
        to_np(getattr(pm.opt, f.name)), np.asarray(getattr(jm.opt, f.name)),
        err_msg=f"opt.{f.name}")
  assert pm.names == {k: list(v) for k, v in jm.names.items()}
  # the device-side copies are the host tables themselves
  for k in tmodel.DEVICE_MASKS + tmodel.DEVICE_INDICES:
    np.testing.assert_array_equal(to_np(pm.dev[k]), np.asarray(getattr(pm, k)),
                                  err_msg=f"dev.{k}")
  jcp, pcp = jm.collision_pairs, pm.collision_pairs
  assert pcp.ncon == jcp.ncon and len(pcp.groups) == len(jcp.groups)
  for jg, pg in zip(jcp.groups, pcp.groups):
    assert pg.types == tuple(jg.types)
    assert pg.ncon_per_pair == jg.ncon_per_pair and pg.count == jg.count
    np.testing.assert_array_equal(pg.geom1, jg.geom1)
    np.testing.assert_array_equal(pg.geom2, jg.geom2)
  for k in ("con_condim", "con_friction", "con_solref", "con_solimp",
            "con_includemargin"):
    if jcp.ncon:
      np.testing.assert_array_equal(getattr(pcp, k), getattr(jcp, k),
                                    err_msg=k)


@pytest.mark.parametrize("name", TASKS)
def test_task_surface_equals_jax(name):
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  np.testing.assert_array_equal(to_np(pt.residual_params),
                                np.asarray(jt.residual_params))
  np.testing.assert_array_equal(pt.home_qpos, jt.home_qpos)
  assert pt.modes == jt.modes
  for key in ("agent_horizon", "agent_timestep", "sampling_spline_points",
              "sampling_exploration", "no_such_numeric"):
    assert pt.config(key, -1.0) == jt.config(key, -1.0), key
  jd, pd = jt.make_data(), pt.make_data()
  for f in dataclasses.fields(tmodel.Data):
    np.testing.assert_array_equal(to_np(getattr(pd, f.name)),
                                  np.asarray(getattr(jd, f.name)),
                                  err_msg=f.name)
  assert float(pt.plan_model.opt.timestep) == \
      float(jt.plan_model.opt.timestep)
  # the planning contacts
  assert getattr(pt, "plan_contact_geoms", None) == \
      getattr(jt, "plan_contact_geoms", None)
  assert getattr(pt, "plan_body_pairs", False) == \
      getattr(jt, "plan_body_pairs", False)
  assert getattr(pt, "plan_body_pair_types", None) == \
      getattr(jt, "plan_body_pair_types", None)
  if name == "Quadruped Flat":
    assert pt.plan_contact_geoms == jt.plan_contact_geoms
    assert pt.lane_modes == jt.lane_modes
    d0 = jd.replace(time=jax.numpy.asarray(0.37, jax.numpy.float32))
    p0 = pd.replace(time=torch.tensor(0.37))
    np.testing.assert_allclose(
        to_np(pt.lane_residual_spec()["make_aux"](p0, pt.residual_params)),
        np.asarray(jt.lane_residual_spec()["make_aux"](
            d0, jt.residual_params)), atol=1e-6)


@pytest.mark.parametrize("name", TASKS)
def test_committed_record_equals_fresh_export(name):
  """The snapshot under assets/ cannot drift from the JAX task."""
  exporter = _exporter()
  fresh = exporter.build_record(name)
  path = os.path.join(tbase.ASSET_DIR, exporter.ASSETS[name])
  with np.load(path, allow_pickle=False) as z:
    committed = convert.record_from_npz(z)
  # through the file format and back: what a load would see
  fresh = convert.record_from_npz(convert.record_to_npz(fresh))
  _assert_tree_equal(committed, fresh)
  assert committed["name"] == name


@pytest.mark.parametrize("name", TASKS)
def test_committed_record_keeps_the_residual_parameter_order(name):
  """The names of the residual parameters come back in MjModel order, the
  order of residual_params (the record's numerics dict is sorted by name):
  Quadruped Flat's first is residual_select_Gait (its XML's first)."""
  jt = jregistry.get_task(name)
  mjm = jt.mjm
  want = [mjm.numeric(i).name for i in range(mjm.nnumeric)
          if mjm.numeric(i).name.startswith("residual_")]
  path = os.path.join(tbase.ASSET_DIR, _exporter().ASSETS[name])
  with np.load(path, allow_pickle=False) as z:
    record = convert.record_from_npz(z)
  assert record["residual_names"] == want
  assert tregistry.get_task(name, device="cpu").residual_names == want
  numerics = record["numerics"]
  np.testing.assert_array_equal(
      record["residual_params"],
      np.asarray([numerics[n] for n in want], np.float32))
  if name == "Quadruped Flat":
    assert want[0] == "residual_select_Gait"
    assert float(record["residual_params"][0]) == 2.0


def test_task_from_record_and_data_from_numpy():
  pt = tregistry.get_task("Cartpole", device="cpu")
  again = type(pt).from_record(pt.record, device="cpu")
  assert again.model.nq == pt.model.nq
  assert torch.equal(again.cost_spec.weights, pt.cost_spec.weights)
  d = convert.data_from_numpy(pt.model, qpos=[0.1, 0.2], time=0.5)
  assert d.qpos.tolist() == pytest.approx([0.1, 0.2])
  assert float(d.time) == 0.5 and d.qvel.shape == (2,)
  assert tregistry.task_names() == [
      "Cartpole", "Cube Solving", "Hand Reorient", "Humanoid Stand",
      "Humanoid Track", "Humanoid Walk", "Quadrotor", "Quadruped Flat",
      "Rubik", "Swimmer"]
  with pytest.raises(KeyError):
    tregistry.get_task("Walker", device="cpu")


def test_entry_points_raise_without_the_requested_device():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tregistry.get_task("Cartpole")          # default device is "cuda"


def _python_files():
  out = [os.path.join(ROOT, "chip_smoke.py")]
  for d, _, files in os.walk(os.path.join(ROOT, "mujoco_mpc_tpu_torch")):
    out += [os.path.join(d, f) for f in files if f.endswith(".py")]
  return out


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
  banned = re.compile(
      r"^\s*(?:import|from)\s+(jax|flax|mujoco|mujoco_mpc_tpu)(?:\.|\s|$)",
      re.M)
  files = _python_files()
  assert len(files) > 15
  for path in files:
    with open(path) as f:
      hit = banned.search(f.read())
    assert hit is None, f"{path}: {hit.group(0).strip()!r}"


def test_port_uses_no_compiler_shortcuts_or_library_solvers():
  """No torch.compile, no Triton anywhere in the port, and no library
  factorisation or matrix product where a kernel's arithmetic lives (ops/,
  the planners' plain versions of the kernels): the rollout's Cholesky and
  Newton, the batched Cholesky solve and the Riccati sweep's Gauss-Jordan
  are their own. Two files are let library calls, as the JAX package
  leaves these to its array library: physics/smooth.py factors and solves
  the pipeline's SPD systems on its differentiable route with
  `torch.linalg.cholesky_ex` and `torch.linalg.solve_triangular`, and
  spline.py solves the spline fit's normal equations with
  `torch.linalg.solve_ex`; every other library solve is refused there
  too."""
  banned = re.compile(r"torch\.compile|import triton|cpp_extension")
  banned_solvers = re.compile(
      r"torch\.linalg|cholesky_solve|torch\.cholesky|torch\.inverse|"
      r"torch\.(?:lu|qr|svd|pinverse|lstsq)\b")
  allowed = {
      # one factor, two solves
      os.path.join("physics", "smooth.py"): (re.compile(
          r"torch\.linalg\.(?:cholesky_ex|solve_triangular)\b"), 3),
      # the fit's one solve
      "spline.py": (re.compile(r"torch\.linalg\.solve_ex\b"), 1)}
  for path in _python_files():
    if path.endswith("chip_smoke.py"):
      continue
    with open(path) as f:
      text = f.read()
    hit = banned.search(text)
    assert hit is None, f"{path}: {hit.group(0)!r}"
    for tail, (pattern, count) in allowed.items():
      if path.endswith(os.sep + tail):
        assert len(pattern.findall(text)) == count, path
        text = pattern.sub("", text)
    hit = banned_solvers.search(text)
    assert hit is None, f"{path}: {hit.group(0)!r}"
  csrc = os.path.join(ROOT, "mujoco_mpc_tpu_torch", "ops", "csrc")
  assert sorted(os.listdir(csrc)) == [
      "chol_solve_lanes.cu", "cube_common.cuh", "humanoid_common.cuh",
      "lane_math.cuh", "lane_rollout.cu", "lane_team.cuh", "residual_hand.cuh",
      "residual_humanoid.cuh", "residual_none.cuh", "residual_quadrotor.cuh",
      "residual_quadruped.cuh", "residual_rubik.cuh", "residual_swimmer.cuh",
      "residual_tracking.cuh", "riccati_backward.cu", "score_fused.cu"]
  for name in os.listdir(csrc):
    with open(os.path.join(csrc, name)) as f:
      text = f.read()
    assert "cublas" not in text.lower() and "cusolver" not in text.lower()
    assert "torch/" not in text
