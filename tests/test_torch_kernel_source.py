"""The CUDA source's arithmetic, run on the CPU.

There is no CUDA compiler where these tests run, but `lane_rollout.cu` is
plain C++ apart from a handful of CUDA names. With those stood in for by
`tests/cuda_host_shim/cuda_runtime.h` (one thread at a time in a loop) the
host compiler builds the very source the card runs, and its output is held
against the plain PyTorch version. Both run in float64 here (`float`
redefined): the rollout is discontinuous at solver gates, so float32
rounding would flip a gate now and then, while in float64 the two agree
to ~1e-9 whenever the code paths are the same — which is what this test
is after. What only the card can show (nvcc, registers, launches, float32
agreement) is chip_smoke.py's part.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch.ops import _build
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests import models as tm
from tests.torch_port_helpers import (BALL, LIMITED, MIXED_CONTACTS,
                                      models_from_xml)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-7


def _host_build(defines, tmp_path):
  gxx = shutil.which("g++") or shutil.which("c++")
  if gxx is None:
    pytest.skip("no host C++ compiler")
  with open(os.path.join(_build.CSRC, "lane_rollout.cu")) as f:
    src = f.read()
  src, n = re.subn(r"lane_rollout_kernel<<<\s*grid,\s*BLOCK,[^>]*>>>\(",
                   "EMU_LAUNCH(lane_rollout_kernel, grid, BLOCK, ", src)
  assert n == 1
  fns = "pow sin cos sqrt fmax fmin fabs fmod cosh exp log1p".split()
  inject = "#define float double\n" + "".join(
      f"#define {f}f {f}\n" for f in fns)
  src = src.replace("#include <math.h>\n", "#include <math.h>\n" + inject, 1)
  flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
  key = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:12]
  cpp = os.path.join(tmp_path, f"lane_{key}.cpp")
  lib = os.path.join(tmp_path, f"lane_{key}.so")
  with open(cpp, "w") as f:
    f.write(src)
  # -fpack-struct: int and double members interleave without padding, as
  # the 4-byte members of the real build do
  cmd = [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         "-fpack-struct=1", "-w", f"-I{HERE}/cuda_host_shim",
         f"-I{_build.CSRC}", *flags, "-o", lib, cpp]
  done = subprocess.run(cmd, capture_output=True, text=True)
  assert done.returncode == 0, done.stderr[-4000:]
  return ctypes.CDLL(lib)


def _run_host(kern, outs, qpos, qvel, values, aux, tmp_path):
  lib = _host_build(kern.build_defines(), str(tmp_path))
  blob = kern.tables()
  lib.lane_tables_size.restype = ctypes.c_int
  assert lib.lane_tables_size() == len(blob)
  assert lib.lane_set_tables(blob, len(blob), None) == 0
  ptr = lambda x: ctypes.c_void_p(x.data_ptr())
  aux = values if aux is None else aux
  second = outs[1] if len(outs) > 1 else outs[0]
  assert lib.lane_rollout(ptr(qpos), ptr(qvel), ptr(values), ptr(aux),
                          ptr(outs[0]), ptr(second),
                          ctypes.c_int(qpos.shape[1]), None) == 0


def _rand(rng, *shape, scale=1.0):
  return torch.as_tensor(scale * rng.standard_normal(shape))


SMALL = {
    "chain": (tm.CHAIN, 8, 2),
    "limits": (LIMITED, 8, 2),
    "bounce": (tm.BOUNCE, 10, 1),
    "pyramidal_condim1": (BALL.format(cone="pyramidal", condim=1,
                                      floor_condim=1, impratio=1.0), 8, 1),
    "pyramidal_condim6": (BALL.format(cone="pyramidal", condim=6,
                                      floor_condim=3, impratio=10.0), 8, 1),
    "elliptic_condim3": (BALL.format(cone="elliptic", condim=3,
                                     floor_condim=3, impratio=1.0), 8, 1),
    "elliptic_condim4": (BALL.format(cone="elliptic", condim=4,
                                     floor_condim=3, impratio=1.0), 8, 1),
    "elliptic_condim6": (BALL.format(cone="elliptic", condim=6,
                                     floor_condim=3, impratio=10.0), 8, 1),
    # blocks padded to the largest condim and the largest support
    "elliptic_mixed": (MIXED_CONTACTS, 8, 1),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_cuda_source_states_mode_matches_plain(name, tmp_path):
  xml, horizon, p = SMALL[name]
  _, pm, mjm = models_from_xml(xml)
  kern = tstep.build_rollout_kernel(pm, horizon, p,
                                    _table_float=np.float64)
  rng = np.random.default_rng(1)
  k = 6
  qpos = torch.as_tensor(np.tile(mjm.qpos0[:, None], (1, k)))
  if name == "elliptic_mixed":
    qpos[2] = 0.0995                    # ball pressed into the floor
    qpos[7] = torch.as_tensor(0.68 + 0.02 * rng.standard_normal(k))  # tip down
    qvel = _rand(rng, pm.nv, k, scale=0.5)
    defs = kern.build_defines()
    assert (defs["LR_NECON"], defs["LR_EROWS"], defs["LR_NSUP"]) == (2, 6, 6)
  elif pm.nq == 7:    # the ball: pressed into the floor, sliding, spinning
    qpos[2] = torch.as_tensor(0.0995 + 0.002 * rng.standard_normal(k))
    qvel = torch.as_tensor(np.tile(
        np.array([0.8, 0, -0.5, 3.0, 0, 6.0])[:, None], (1, k)))
    qvel = qvel + _rand(rng, pm.nv, k, scale=0.1)
  else:
    qpos = qpos + _rand(rng, pm.nq, k, scale=0.4)
    qvel = _rand(rng, pm.nv, k)
  values = torch.as_tensor(rng.uniform(-1.5, 1.5, (max(p * pm.nu, 1), k)))
  want = kern.plain(qpos, qvel, values[:p * pm.nu])
  got = torch.zeros_like(want)
  _run_host(kern, [got], qpos, qvel, values, None, tmp_path)
  assert torch.isfinite(want).all()
  torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", ["residual_rows", "cost_sums"])
def test_cuda_source_quadruped_matches_plain(mode, tmp_path):
  """The main path's specialisation: elliptic condim-6 feet, 12 limited
  joints, the hand-written quadruped residual, both planner modes."""
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  horizon, p, k = 5, 3, 6
  cost_terms = tuple(zip(cs.norm_types, cs.dims)) \
      if mode == "cost_sums" else None
  kern = tstep.build_rollout_kernel(
      pt.plan_model, horizon, p, contact_types=(GEOM_SPHERE,),
      contact_geoms=pt.plan_contact_geoms, residual=spec,
      naux=spec["naux"], record_states=False, cost_terms=cost_terms,
      _table_float=np.float64)
  rng = np.random.default_rng(2)
  d0 = pt.make_data().replace(time=torch.tensor(0.21))
  aux = spec["make_aux"](d0, pt.residual_params)
  if cost_terms:
    aux = torch.cat([aux, cs.norm_params[:, :2].reshape(-1)])
  aux = aux.double()[:, None].repeat(1, k).contiguous()
  qpos = d0.qpos.double()[:, None].repeat(1, k)
  qpos[2] += torch.as_tensor(0.01 * rng.standard_normal(k))
  qpos[7:] += _rand(rng, 12, k, scale=0.05)
  qvel = _rand(rng, 18, k, scale=0.2)
  home = torch.as_tensor(np.tile(pt.home_qpos[7:], p))[:, None]
  values = (home + _rand(rng, p * 12, k, scale=0.1)).contiguous()
  want = kern.plain(qpos, qvel, values, aux)
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos.contiguous(), qvel, values, aux, tmp_path)
  for g, w in zip(got, want):
    assert torch.isfinite(w).all()
    torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_cuda_source_quadruped_full_horizon_on_the_floor(tmp_path):
  """The main path's inputs at its full horizon: home pose standing on the
  floor, the initial (mid-range) policy plus exploration noise, 36 steps in
  cost-sum mode. In float64 no solver gate flips between the two, so the
  source and the plain version agree over the whole contact-rich rollout
  — every branch those rollouts take — and they agree on which candidates
  blow up."""
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  horizon, p, k = 36, 3, 24
  cost_terms = tuple(zip(cs.norm_types, cs.dims))
  kern = tstep.build_rollout_kernel(
      pt.plan_model, horizon, p, contact_types=(GEOM_SPHERE,),
      contact_geoms=pt.plan_contact_geoms, residual=spec,
      naux=spec["naux"], record_states=False, cost_terms=cost_terms,
      _table_float=np.float64)
  rng = np.random.default_rng(3)
  d0 = pt.make_data()
  aux = torch.cat([spec["make_aux"](d0, pt.residual_params),
                   cs.norm_params[:, :2].reshape(-1)])
  aux = aux.double()[:, None].repeat(1, k).contiguous()
  qpos = d0.qpos.double()[:, None].repeat(1, k).contiguous()
  qvel = d0.qvel.double()[:, None].repeat(1, k).contiguous()
  lo = pt.plan_model.actuator_ctrlrange[:, 0].double().numpy()
  hi = pt.plan_model.actuator_ctrlrange[:, 1].double().numpy()
  cand = 0.5 * (lo + hi) + 0.04 * 0.5 * (hi - lo) * rng.standard_normal(
      (k, p, 12))
  values = torch.as_tensor(
      np.clip(cand, lo, hi).reshape(k, p * 12).T.copy())
  want = kern.plain(qpos, qvel, values, aux)
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos, qvel, values, aux, tmp_path)
  alive = torch.isfinite(want[1]).all(dim=0) & \
      (want[1][19:].abs().amax(dim=0) < 100.0)
  assert int(alive.sum()) >= k // 2, alive
  torch.testing.assert_close(torch.isfinite(got[1]).all(dim=0),
                             torch.isfinite(want[1]).all(dim=0))
  for g, w in zip(got, want):
    torch.testing.assert_close(g[:, alive], w[:, alive], atol=TOL, rtol=TOL)
