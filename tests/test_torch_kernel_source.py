"""The CUDA sources' arithmetic, run on the CPU.

There is no CUDA compiler where these tests run, but the kernel sources
(`lane_rollout.cu`, `riccati_backward.cu`, `score_fused.cu`,
`chol_solve_lanes.cu`) are plain C++ apart from a handful of CUDA names. With those stood in for by
`tests/cuda_host_shim/cuda_runtime.h` (one thread at a time in a loop) the
host compiler builds the very source the card runs, and its output is held
against the plain PyTorch version. Both run in float64 here (`float`
redefined): the rollout is discontinuous at solver gates, so float32
rounding would flip a gate now and then, while in float64 the two agree
to ~1e-9 whenever the code paths are the same — which is what this test
is after. The Riccati kernel is a block of cooperating threads; here its
block has ONE thread, whose strided loops then cover all the work in
order, and the barriers are no-ops; the fused scoring kernel runs one
slice of the horizon a block there (its slices meet in a block-wide sum).
Built with EMU_THREADS, a block's threads run as concurrent host threads
(the shim's barriers and shuffles exchange between them), so a missing
barrier shows as a mismatch. What only the card can show (nvcc,
registers, launches, float32 agreement) is chip_smoke.py's part, and the
`cuda`-marked tests here (`pytest -m cuda`).
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
from mujoco_mpc_tpu_torch.ops import cholesky as tcholesky
from mujoco_mpc_tpu_torch.ops import riccati_lane as triccati
from mujoco_mpc_tpu_torch.ops import scoring as tscoring
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests import models as tm
from tests.torch_port_helpers import (BALL, DROP, DROP_GEOMS, LIMITED,
                                      MIXED_CONTACTS, PAIR_GEOMS, clearances,
                                      models_from_xml, pair_states, pair_xml,
                                      riccati_problem)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-7


def _host_build(defines, tmp_path, source="lane_rollout.cu", extra_flags=()):
  gxx = shutil.which("g++") or shutil.which("c++")
  if gxx is None:
    pytest.skip("no host C++ compiler")
  with open(os.path.join(_build.CSRC, source)) as f:
    src = f.read()
  src, n = re.subn(r"(\w+_kernel)<<<\s*(\w+),\s*(\w+),\s*(\w+),[^>]*>>>\(",
                   r"EMU_LAUNCH(\1, \2, \3, \4, ", src)
  assert n == 1
  fns = "pow sin cos sqrt fmax fmin fabs fmod cosh exp log1p atan2".split()
  inject = "#define float double\n" + "".join(
      f"#define {f}f {f}\n" for f in fns)
  src = src.replace("#include <math.h>\n", "#include <math.h>\n" + inject, 1)
  flags = [f"-D{k}={v}" for k, v in sorted(defines.items())] + \
      list(extra_flags)
  key = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:12]
  cpp = os.path.join(tmp_path, f"kernel_{key}.cpp")
  lib = os.path.join(tmp_path, f"kernel_{key}.so")
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


def _run_host(kern, outs, qpos, qvel, values, aux, tmp_path, table=None,
              teams=1, team=1):
  """The source built for the host at `team` lanes a team (LR_TEAM; the
  build's other defines unchanged), `teams` teams a block. One lane runs
  one thread at a time; more lanes run as concurrent host threads
  (EMU_THREADS), a block holding one team."""
  extra = () if team == 1 else ("-DEMU_THREADS=1", "-pthread")
  assert team == 1 or teams == 1
  lib = _host_build(dict(kern.build_defines(), LR_TEAM=team), str(tmp_path),
                    extra_flags=extra)
  blob = kern.tables()
  lib.lane_tables_size.restype = ctypes.c_int
  assert lib.lane_tables_size() == len(blob)
  assert lib.lane_set_tables(blob, len(blob), None) == 0
  ptr = lambda x: ctypes.c_void_p(x.data_ptr())
  aux = values if aux is None else aux
  table = values if table is None else table
  second = outs[1] if len(outs) > 1 else outs[0]
  k = qpos.shape[1]
  ws = torch.full((max(lib.lane_workspace_floats() * k, 1),), float("nan"),
                  dtype=torch.float64)
  assert lib.lane_rollout(ptr(qpos), ptr(qvel), ptr(values), ptr(aux),
                          ptr(table), ptr(outs[0]), ptr(second), ptr(ws),
                          ctypes.c_int(k), ctypes.c_int(teams), None) == 0
  return lib


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


def test_cuda_source_swimmer_feedback_with_fluid_matches_plain(tmp_path):
  """iLQG's line-search launch on Swimmer: the feedback control law (random
  gains of realistic size around a random nominal) and the inertia-box
  fluid forces, recorded states and residual rows over 12 steps."""
  pt = tregistry.get_task("Swimmer", device="cpu")
  m = pt.plan_model
  spec = pt.lane_residual_spec()
  horizon, k = 12, 6
  kern = tstep.build_rollout_kernel(
      m, horizon, 1, residual=spec, naux=spec["naux"], record_states=True,
      feedback=True, _table_float=np.float64)
  defs = kern.build_defines()
  assert (defs["LR_CTRL"], defs["LR_FLUID"]) == (1, 1)
  nq, nv, nu, ndx = m.nq, m.nv, m.nu, 2 * m.nv
  assert kern.stride == 2 * nu + nu * ndx + nq + nv == 106
  rng = np.random.default_rng(5)
  d0 = pt.make_data()
  qpos = d0.qpos.double()[:, None].repeat(1, k) + _rand(rng, nq, k, scale=0.2)
  qvel = _rand(rng, nv, k, scale=0.5)
  x_nom = np.concatenate([d0.qpos.numpy(), np.zeros(nv)])[None] + \
      0.2 * rng.standard_normal((horizon, nq + nv))
  blocks = np.concatenate([
      rng.uniform(-0.8, 0.8, (horizon, nu)),             # u_nom
      0.3 * rng.standard_normal((horizon, nu)),          # k
      0.5 * rng.standard_normal((horizon, nu * ndx)),    # K
      x_nom], axis=1)
  table = torch.as_tensor(blocks.reshape(-1).copy())
  values = torch.as_tensor(np.stack([
      rng.uniform(0, 1, k), rng.uniform(0, 1, k)]))
  aux = torch.as_tensor(np.tile(np.array([0.5, 0.5])[:, None], (1, k)))
  want = kern.plain(qpos, qvel, values, aux, table)
  got = torch.zeros_like(want)
  _run_host(kern, [got], qpos.contiguous(), qvel, values, aux, tmp_path,
            table=table)
  assert torch.isfinite(want).all()
  # the controls (first nu residual rows) hit the clip on some steps
  ctrl = want[:, nq + nv:nq + nv + nu]
  assert (ctrl.abs() == 1.0).any() and (ctrl.abs() < 1.0).any()
  torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("kind", ["capsule", "box"])
def test_cuda_source_capsule_and_box_ground_match_plain(kind, cone, tmp_path):
  """Capsule ends and box corners as contact table entries: a tilted free
  capsule / box pressed 0.5 to 3 mm into the floor, sliding, 8 steps."""
  _, pm, mjm = models_from_xml(DROP.format(cone=cone, geom=DROP_GEOMS[kind]))
  kern = tstep.build_rollout_kernel(pm, 8, 1, _table_float=np.float64)
  assert kern.build_defines()["LR_NCON"] == {"capsule": 2, "box": 8}[kind]
  rng = np.random.default_rng(8)
  k = 4
  qpos = np.tile(mjm.qpos0[:, None], (1, k))
  qpos[3:7] += 0.3 * rng.standard_normal((4, k))
  qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
  qpos[2] -= clearances(pm, qpos) + np.array([0.0005, 0.001, 0.002, 0.003])
  qpos = torch.as_tensor(qpos)
  qvel = _rand(rng, pm.nv, k, scale=0.3)
  values = torch.zeros((1, k), dtype=torch.float64)
  want = kern.plain(qpos, qvel, values[:0])
  got = torch.zeros_like(want)
  _run_host(kern, [got], qpos, qvel, values, None, tmp_path)
  assert torch.isfinite(want).all()
  torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_cuda_source_quadrotor_site_transmission_matches_plain(tmp_path):
  """Four site-transmission rotors, asymmetric thrusts, 12 steps, recorded
  states and residual rows; one lane starts with its box core on the
  floor (eight corner points)."""
  pt = tregistry.get_task("Quadrotor", device="cpu")
  spec = pt.lane_residual_spec()
  horizon, p, k = 12, 3, 4
  kern = tstep.build_rollout_kernel(pt.plan_model, horizon, p, residual=spec,
                                    naux=spec["naux"],
                                    _table_float=np.float64)
  defs = kern.build_defines()
  assert (defs["LR_SITE"], defs["LR_NCON"]) == (1, 8)
  rng = np.random.default_rng(9)
  qpos = np.tile(np.asarray(pt.home_qpos)[:, None], (1, k))
  qpos[2] += 0.5 + 0.1 * rng.standard_normal(k)
  qpos[3:7] += 0.1 * rng.standard_normal((4, k))
  qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
  qpos[:, 3] = [0, 0, 0.029, 1, 0, 0, 0]
  qpos = torch.as_tensor(qpos)
  qvel = _rand(rng, 6, k, scale=0.3)
  values = torch.as_tensor(rng.uniform(0.5, 3.5, (p * 4, k)))
  aux = torch.as_tensor(np.tile(np.array([0.3, -0.2, 1.5])[:, None], (1, k)))
  want = kern.plain(qpos, qvel, values, aux)
  got = torch.zeros_like(want)
  _run_host(kern, [got], qpos, qvel, values, aux, tmp_path)
  assert torch.isfinite(want).all()
  torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["Humanoid Track", "Humanoid Stand"])
def test_cuda_source_humanoid_cost_sums_match_plain(name, tmp_path):
  """The humanoid specialisations of the slice's paths in cost-sum mode: 39
  ground contact points (sphere, capsule ends, box corners), 21 limited
  joints, the hand-written residuals; Track reads every target through
  aux_at (per-step rows), Stand keeps its aux rows in registers. Standing
  with the feet pressed into the floor, 6 steps."""
  pt = tregistry.get_task(name, device="cpu")
  horizon, p, k = 6, 2, 4
  spec = pt.lane_residual_spec(horizon=horizon) \
      if name == "Humanoid Track" else pt.lane_residual_spec()
  cs = pt.cost_spec
  kern = tstep.build_rollout_kernel(
      pt.plan_model, horizon, p, residual=spec, naux=spec["naux"],
      record_states=False, cost_terms=tuple(zip(cs.norm_types, cs.dims)),
      _table_float=np.float64)
  defs = kern.build_defines()
  assert (defs["LR_NCON"], defs["LR_NPROW"], defs["LR_NSUP"]) == (39, 156, 15)
  assert defs["LR_NAUXS"] == (0 if name == "Humanoid Track" else 2)
  rng = np.random.default_rng(10)
  d0 = pt.make_data().replace(time=torch.tensor(0.37))
  aux = torch.cat([spec["make_aux"](d0, pt.residual_params),
                   cs.norm_params[:, :2].reshape(-1)])
  aux = aux.double()[:, None].repeat(1, k).contiguous()
  qpos = np.tile(np.asarray(pt.home_qpos)[:, None], (1, k))
  qpos[7:] += 0.05 * rng.standard_normal((21, k))
  qpos[2] -= clearances(pt.plan_model, qpos) + 0.001 * np.arange(1, k + 1)
  qpos = torch.as_tensor(qpos)
  qvel = _rand(rng, 27, k, scale=0.1)
  values = torch.as_tensor(rng.uniform(-0.5, 0.5, (p * 21, k)))
  want = kern.plain(qpos, qvel, values, aux)
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos, qvel, values, aux, tmp_path)
  for g, w in zip(got, want):
    assert torch.isfinite(w).all()
    torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def _run_riccati_host(kern, prob, reg, tmp_path, threads=False):
  """The Riccati source built for the host: a block of one thread, the QP
  warp one lane (every loop the serial loop), or with `threads` a block of
  16 host threads (EMU_THREADS) in two warps of 8 (EMU_WARP), the QP warp
  the first: its rows and columns strided over 8 lanes, the second warp
  waiting at the block barrier meanwhile."""
  defines = dict(kern.build_defines(), RB_BLOCK=16, RB_QP_LANES=8) \
      if threads else dict(kern.build_defines(), RB_BLOCK=1, RB_QP_LANES=1)
  extra = ("-DEMU_THREADS=1", "-DEMU_WARP=8", "-pthread") if threads else ()
  lib = _host_build(defines, str(tmp_path), source="riccati_backward.cu",
                    extra_flags=extra)
  lib.riccati_workspace_floats.restype = ctypes.c_int
  assert lib.riccati_workspace_floats() == kern.workspace_floats
  t, nu = prob[3].shape
  ndx = prob[2].shape[1]
  ks = torch.zeros((t - 1, nu), dtype=torch.float64)
  kmats = torch.zeros((t - 1, nu, ndx), dtype=torch.float64)
  out = torch.zeros(3, dtype=torch.float64)
  ptr = lambda x: ctypes.c_void_p(x.data_ptr())
  ins = [x.contiguous() for x in prob] + [reg.reshape(1)]
  assert lib.riccati_backward(*[ptr(x) for x in ins], ptr(ks), ptr(kmats),
                              ptr(out), None, None) == 0
  return ks, kmats, out


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
  """One directory for the module's host builds: cases that differ only in
  their inputs share a library."""
  return tmp_path_factory.mktemp("host_builds")


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("kind", sorted(PAIR_GEOMS))
def test_cuda_source_body_pair_matches_plain(kind, cone, tmp_path):
  """The body-pair branch (LR_BODY): a hinged arm's geom and a free body's
  in contact at five distances (a point in a box also with its centre
  inside), 6 recorded steps, pyramidal condim 3 and elliptic condim 6."""
  condim, impratio = (3, 1.0) if cone == "pyramidal" else (6, 10.0)
  _, pm, _ = models_from_xml(pair_xml(kind, cone, condim, impratio))
  kern = tstep.build_rollout_kernel(pm, 6, 1, body_pairs=True,
                                    _table_float=np.float64)
  assert kern.build_defines()["LR_BODY"] == 1
  qpos, qvel = pair_states(kind, pm.nv, np.random.default_rng(5))
  qpos, qvel = torch.as_tensor(qpos), torch.as_tensor(qvel)
  values = torch.zeros((1, qpos.shape[1]), dtype=torch.float64)
  want = kern.plain(qpos, qvel, values[:0])
  got = torch.zeros_like(want)
  _run_host(kern, [got], qpos, qvel, values, None, tmp_path)
  assert torch.isfinite(want).all()
  torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["Rubik", "Cube Solving", "Hand Reorient"])
def test_cuda_source_hand_task_cost_sums_match_plain(name, tmp_path):
  """The path builds of the hand tasks (their planning contacts, body pairs
  and residuals) in cost-sum mode, H=2, K=4, from home poses with the hand
  perturbed (Rubik's fingertips 14 mm into each other at home); Rubik's
  tables are past 64 KB."""
  pt = tregistry.get_task(name, device="cpu")
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  m = pt.plan_model
  horizon, p, k = 2, 3, 4
  kern = tstep.build_rollout_kernel(
      m, horizon, p, residual=spec, naux=spec["naux"], record_states=False,
      cost_terms=tuple(zip(cs.norm_types, cs.dims)),
      contact_geoms=getattr(pt, "plan_contact_geoms", None), body_pairs=True,
      body_pair_types=getattr(pt, "plan_body_pair_types", None),
      _table_float=np.float64)
  defs = kern.build_defines()
  assert defs["LR_BODY"] == 1
  # Rubik's tables are past the 64 KB a __constant__ bank could hold
  assert (len(kern.tables()) > 64 * 1024) == (name == "Rubik")
  rng = np.random.default_rng(6)
  qpos = torch.as_tensor(np.tile(pt.home_qpos[:, None], (1, k)))
  qpos[:pt._nhand] += _rand(rng, pt._nhand, k, scale=0.05)
  qvel = _rand(rng, m.nv, k, scale=0.05)
  lo = m.actuator_ctrlrange[:, 0].double().numpy()
  hi = m.actuator_ctrlrange[:, 1].double().numpy()
  values = torch.as_tensor(rng.uniform(lo, hi, (k, p, m.nu)).reshape(
      k, p * m.nu).T.copy())
  aux = torch.cat([spec["make_aux"](pt.make_data(), pt.residual_params),
                   cs.norm_params[:, :2].reshape(-1)])
  aux = aux.double()[:, None].repeat(1, k).contiguous()
  want = kern.plain(qpos, qvel, values, aux)
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos.contiguous(), qvel, values, aux, tmp_path)
  for g, w in zip(got, want):
    assert torch.isfinite(w).all()
    torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("reg_type", [0, 1, 2, 3])
@pytest.mark.parametrize("tight_limits", [False, True])
@pytest.mark.parametrize("ndx,nu,horizon", [(7, 3, 6), (16, 5, 12),
                                            (36, 12, 5), (128, 32, 3)])
def test_riccati_source_matches_backward_pass(ndx, nu, horizon, tight_limits,
                                              reg_type, host_dir):
  """The Riccati kernel's source against its plain version, float64, on
  problems whose box-QP decisions have margins; with tight limits controls
  sit on their bounds and the free-set inverse is exercised. One thread,
  up to the gate's largest size, whose workspace still fits the shared
  memory of a block."""
  prob = [torch.as_tensor(x).double() for x in riccati_problem(
      horizon, ndx, nu, seed=100 + reg_type * 2 + tight_limits,
      tight_limits=tight_limits)]
  reg = torch.tensor(1e-2, dtype=torch.float64)
  kern = triccati.build_backward_kernel(ndx, nu, horizon, 6, reg_type)
  assert kern.layout["shared_bytes"] == 4 * kern.workspace_floats <= 232448
  ks_w, km_w, (dv1, dv2), ok = tilqg.backward_pass(*prob, reg, 6, reg_type)
  ks, kmats, out = _run_riccati_host(kern, prob, reg, host_dir)
  assert bool(ok) and float(out[2]) == 0.0
  if tight_limits:
    assert (ks_w.abs() == float(np.float32(0.05))).any()
  torch.testing.assert_close(ks, ks_w, atol=TOL, rtol=TOL)
  torch.testing.assert_close(kmats, km_w, atol=TOL, rtol=TOL)
  torch.testing.assert_close(out[0], dv1, atol=TOL, rtol=TOL)
  torch.testing.assert_close(out[1], dv2, atol=TOL, rtol=TOL)


def test_riccati_source_flags_non_finite_input(tmp_path):
  prob = [torch.as_tensor(x).double() for x in riccati_problem(
      6, 7, 3, seed=1, tight_limits=False)]
  prob[2][2, 1] = float("nan")       # cx at t = 2
  reg = torch.tensor(1e-2, dtype=torch.float64)
  kern = triccati.build_backward_kernel(7, 3, 6, 6, 0)
  _, _, out = _run_riccati_host(kern, prob, reg, tmp_path)
  assert float(out[2]) == 1.0
  assert not bool(tilqg.backward_pass(*prob, reg, 6, 0)[3])


@pytest.mark.parametrize("reg_type", [0, 1, 2, 3])
@pytest.mark.parametrize("ndx,nu,horizon,qp_iters,case", [
    (16, 5, 8, 6, "tight"), (36, 12, 3, 6, "loose"),
    (128, 32, 2, 2, "loose"), (16, 5, 4, 6, "non_finite")])
def test_riccati_source_threads_match_backward_pass(ndx, nu, horizon,
                                                    qp_iters, case, reg_type,
                                                    host_dir):
  """The Riccati source with its block as 16 host threads (EMU_THREADS):
  the QP warp's rows and columns on 8 lanes exchanging by shuffles, the
  block phases split between the threads, so a missing barrier shows as a
  mismatch.
  Float64 against the plain version: limits that clamp (Swimmer's size),
  loose limits at a quadruped's and the gate's largest size, and a NaN in
  cx at t = 2 flagged as in the plain version. Host threads exchange
  slowly (two barriers a shuffle), so the sweeps are short and the gate's
  largest size runs 2 box-QP iterations (its 32 x 32 inverses)."""
  prob = [torch.as_tensor(x).double() for x in riccati_problem(
      horizon, ndx, nu, seed=200 + reg_type, tight_limits=case == "tight")]
  if case == "non_finite":
    prob[2][2, 1] = float("nan")
  reg = torch.tensor(1e-2, dtype=torch.float64)
  kern = triccati.build_backward_kernel(ndx, nu, horizon, qp_iters, reg_type)
  ks_w, km_w, (dv1, dv2), ok = tilqg.backward_pass(*prob, reg, qp_iters,
                                                   reg_type)
  ks, kmats, out = _run_riccati_host(kern, prob, reg, host_dir, threads=True)
  if case == "non_finite":
    assert float(out[2]) == 1.0 and not bool(ok)
    return
  assert bool(ok) and float(out[2]) == 0.0
  if case == "tight":
    assert (ks_w.abs() == float(np.float32(0.05))).any()
  torch.testing.assert_close(ks, ks_w, atol=TOL, rtol=TOL)
  torch.testing.assert_close(kmats, km_w, atol=TOL, rtol=TOL)
  torch.testing.assert_close(out[0], dv1, atol=TOL, rtol=TOL)
  torch.testing.assert_close(out[1], dv2, atol=TOL, rtol=TOL)


def test_cuda_source_swimmer_cost_sums_with_fluid_matches_plain(tmp_path):
  """The clean scoring launch of the robust and iLQS paths on Swimmer: the
  spline control, the inertia-box fluid forces and the in-kernel residual
  reduced to per-term cost sums (a specialisation the iLQG path never
  builds), 12 steps."""
  pt = tregistry.get_task("Swimmer", device="cpu")
  m = pt.plan_model
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  horizon, p, k = 12, 4, 6
  kern = tstep.build_rollout_kernel(
      m, horizon, p, residual=spec, naux=spec["naux"], record_states=False,
      cost_terms=tuple(zip(cs.norm_types, cs.dims)),
      _table_float=np.float64)
  defs = kern.build_defines()
  assert (defs["LR_MODE"], defs["LR_FLUID"], defs["LR_CTRL"]) == (
      tstep.MODE_COST_SUMS, 1, 0)
  rng = np.random.default_rng(6)
  d0 = pt.make_data()
  qpos = d0.qpos.double()[:, None].repeat(1, k) + _rand(rng, m.nq, k,
                                                        scale=0.2)
  qvel = _rand(rng, m.nv, k, scale=0.5)
  values = torch.as_tensor(rng.uniform(-1.2, 1.2, (p * m.nu, k)))
  aux = torch.cat([torch.tensor([0.4, -0.3], dtype=torch.float64),
                   cs.norm_params[:, :2].reshape(-1).double()])
  aux = aux[:, None].repeat(1, k).contiguous()
  want = kern.plain(qpos.contiguous(), qvel, values, aux)
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos.contiguous(), qvel, values, aux, tmp_path)
  for g, w in zip(got, want):
    assert torch.isfinite(w).all()
    torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


SCORE_TASKS = ["Quadruped Flat", "Swimmer", "Cartpole"]


def _score_host(task, directory, threads):
  """The fused scoring source built for the host at `task`'s cost, float64:
  one thread at a time, or with `threads` a block's threads as concurrent
  host threads (EMU_THREADS) in warps of 8 (EMU_WARP, and SF_WARP for the
  source's shuffle tree). Returns (lib, cost spec)."""
  cs = tregistry.get_task(task, device="cpu").cost_spec
  cs = cs.replace(weights=cs.weights.double(),
                  norm_params=cs.norm_params.double())
  extra = ("-DEMU_THREADS=1", "-DEMU_WARP=8", "-DSF_WARP=8", "-pthread") \
      if threads else ()
  lib = _host_build(tscoring.build_defines(cs), str(directory),
                    source="score_fused.cu", extra_flags=extra)
  return lib, cs


def _score_launch(lib, res, cs, tile, slices):
  """Launch the host build on residuals (T, nr, K) of any strides, the
  weights and norm parameters as the wrapper passes them (column 0 of the
  parameters through their row stride)."""
  t_hor, _, k = res.shape
  out = torch.full((k,), float("nan"), dtype=torch.float64)
  ptr = lambda x: ctypes.c_void_p(x.data_ptr())
  ll = ctypes.c_longlong
  err = lib.score_fused(
      ptr(res), *[ll(x) for x in res.stride()], ptr(cs.weights),
      ll(cs.weights.stride(0)), ptr(cs.norm_params),
      ll(cs.norm_params.stride(0)), ptr(out), ctypes.c_int(t_hor),
      ctypes.c_int(k), ctypes.c_int(tile.bit_length() - 1),
      ctypes.c_int(slices), None)
  assert err == 0
  return out


@pytest.mark.parametrize("task", SCORE_TASKS)
def test_score_fused_source_matches_reference(task, tmp_path):
  """The fused scoring kernel's source against the plain cost (mean over
  the horizon of CostSpec.cost), float64, at each ported task's cost: one
  slice a block (the serial host build runs a block's threads one after
  the other, which only a block without a cross-slice sum allows), a tile
  of 8 with K = 5, and a layout the kernel refuses."""
  lib, cs = _score_host(task, tmp_path, threads=False)
  rng = np.random.default_rng(7)
  t_hor, k = 9, 5
  res = torch.as_tensor(rng.standard_normal((t_hor, cs.num_residual, k)))
  out = _score_launch(lib, res, cs, tile=8, slices=1)
  want = tscoring.score_reference(res.permute(2, 0, 1), cs)
  torch.testing.assert_close(out, want, atol=TOL, rtol=TOL)
  # 64 slices of 32 candidates pass MAX_THREADS; 3 slices is no power of 2
  for tile, slices in ((32, 64), (8, 3)):
    assert lib.score_fused(None, *[ctypes.c_longlong(1)] * 3, None,
                           ctypes.c_longlong(1), None, ctypes.c_longlong(1),
                           None, ctypes.c_int(t_hor), ctypes.c_int(k),
                           ctypes.c_int(tile.bit_length() - 1),
                           ctypes.c_int(slices), None) == 1


@pytest.mark.parametrize("lane_layout", [True, False],
                         ids=["rows_T_nr_K", "batch_K_T_nr_permuted"])
@pytest.mark.parametrize("task", SCORE_TASKS)
def test_score_fused_source_slices_as_threads_match_reference(
    task, lane_layout, host_dir):
  """The same source at the launch rule's layout for K = 11, T = 13 on a
  card of 8 SMs (a tile of 2, 16 slices: 32 host threads a block,
  EMU_THREADS, in 4 warps of 8; T not a multiple of the slices, K not of
  the tile), so the slices' partial sums meet across threads, by shuffles
  within a warp and through shared memory across the 4 warps, and a
  missing barrier shows as a mismatch; then the same layout at T = 37,
  two or three steps a slice. On the lane planner's (T, nr, K) rows, and
  on the robust path's (K, T, nr) batch read through a permuted view's
  strides. The norm parameters are a column of a wider tensor, as the
  wrapper passes them."""
  lib, cs = _score_host(task, host_dir, threads=True)
  rng = np.random.default_rng(11)
  k = 11
  tile, slices = tscoring.layout(k, 13, 8)
  assert (tile, slices) == (2, 16) and k % tile
  wide = torch.as_tensor(rng.uniform(0.05, 0.5, (cs.num_term, 5)))
  wide[:, :3] = cs.norm_params
  cs = cs.replace(norm_params=wide[:, :3])
  assert cs.norm_params.stride(0) == 5
  for t_hor in (13, 37):
    batch = torch.as_tensor(rng.standard_normal((k, t_hor,
                                                 cs.num_residual)))
    res = batch.permute(1, 2, 0)
    if lane_layout:
      res = res.contiguous()
      assert res.stride(2) == 1
    else:
      assert res.stride(1) == 1 and not res.is_contiguous()
    out = _score_launch(lib, res, cs, tile, slices)
    want = tscoring.score_reference(batch, cs)
    torch.testing.assert_close(out, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("task,k,t_hor,lane_layout", [
    ("Quadruped Flat", 4096, 36, True), ("Swimmer", 16, 201, False),
    ("Swimmer", 16, 201, True), ("Cartpole", 10, 101, True)])
def test_score_fused_kernel_matches_plain_on_the_card(task, k, t_hor,
                                                      lane_layout):
  """Needs the card: the fused scoring kernel against its plain version at
  the three shapes its callers hand it (the quadruped's cost at K = 4096,
  T = 36; robust's noisy batch on Swimmer, K = 16, T = 201, as the
  pipeline rollouts' permuted (K, T, nr) view and as rows; the Cartpole
  lane planner's K = 10, T = 101), 2e-4 absolute and relative (the JAX
  suite's bar), one launch a call (the full comparison is chip_smoke.py;
  run this with `pytest -m cuda`)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  cs = tregistry.get_task(task, device="cuda").cost_spec
  rng = np.random.default_rng(k + t_hor)
  batch = torch.as_tensor(rng.standard_normal(
      (k, t_hor, cs.num_residual)).astype(np.float32)).cuda()
  res = batch.permute(1, 2, 0)
  if lane_layout:
    res = res.contiguous()
  before = tscoring.launch_count
  got = tscoring.make_scorer(cs, "cuda")(res)
  assert tscoring.launch_count == before + 1
  want = tscoring.score_reference(batch, cs)
  torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def _chol_host(n, k, tmp_path, threads=False, block=4):
  """The batched Cholesky source built for the host at `block` threads (one
  a system) a block, run on K random SPD systems: the block's threads one
  after the other, or with `threads` as concurrent host threads
  (EMU_THREADS). Returns (x, a, b)."""
  extra = ("-DEMU_THREADS=1", "-pthread") if threads else ()
  lib = _host_build(dict(tcholesky.build_defines(n), CS_BLOCK=block),
                    str(tmp_path), source="chol_solve_lanes.cu",
                    extra_flags=extra)
  rng = np.random.default_rng(n)
  g = rng.standard_normal((k, n, n))
  a = np.einsum("kij,klj->kil", g, g) + n * np.eye(n)[None]
  a = torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))
  b = torch.as_tensor(rng.standard_normal((n, k)))
  x = torch.full_like(b, float("nan"))
  ptr = lambda t: ctypes.c_void_p(t.data_ptr())
  assert lib.chol_solve_lanes(ptr(a), ptr(b), ptr(x), ctypes.c_int(k),
                              None) == 0
  return x, a, b


@pytest.mark.parametrize("n", [4, 7, 8, 18, 1, 32])
def test_chol_solve_lanes_source_matches_plain(n, tmp_path):
  """The batched Cholesky kernel's source against its plain version,
  float64, on SPD systems (8 is Swimmer's nv, 18 the quadruped's), one
  thread a system, 4 systems a block, K = 9 (the last block part empty)."""
  k = 9
  x, a, b = _chol_host(n, k, tmp_path)
  want = tcholesky.chol_solve_lanes_plain(a, b)
  torch.testing.assert_close(x, want, atol=TOL, rtol=TOL)
  ref = np.linalg.solve(np.moveaxis(a.numpy(), -1, 0), b.numpy().T[..., None])
  np.testing.assert_allclose(x.numpy(), ref[..., 0].T, atol=1e-9)


@pytest.mark.parametrize("n", [1, 8, 18, 32])
def test_chol_solve_lanes_source_lanes_as_threads_match_plain(n, tmp_path):
  """The same source with the lanes of a block as concurrent host threads,
  one system a lane (8 a block, K = 13 not a multiple of it: the last
  block's lanes past K return before touching memory): every system's
  index, bounds check and coalesced row addressing per thread; n = 32
  takes the rolled factorisation (past lane_math.cuh kCholUnrollMax)."""
  x, a, b = _chol_host(n, 13, tmp_path, threads=True, block=8)
  torch.testing.assert_close(x, tcholesky.chol_solve_lanes_plain(a, b),
                             atol=TOL, rtol=TOL)
