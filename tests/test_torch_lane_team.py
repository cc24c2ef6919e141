"""The rollout kernel's team design, run on the CPU.

`ops/csrc/lane_rollout.cu` runs a team of LR_TEAM lanes per candidate and
builds constraint rows only for the contacts and limit sides whose gap is
< 0 (the exact cull), keeping the first LR_ROWCAP / LR_BLKCAP active rows
in shared memory and the rest in a per-candidate global workspace. The
source is compiled for the host through tests/cuda_host_shim (float64,
`float` redefined) and held against the plain PyTorch version, which builds
every row, at the 1e-7 of test_torch_kernel_source.py:

  * at one lane a team, on rollouts where contacts cross zero (some
    candidates touching, some leaving the floor, some never touching), and
    where every contact row is active and the caps are cut so that rows go
    to the global workspace;
  * at four lanes a team with the lanes as concurrent host threads
    (EMU_THREADS: barriers, shuffles and ballots exchange between them), so
    that a missing barrier or a lane reading another's unfinished work
    shows here and not only on the card;
  * a non-finite state stays non-finite through the cull.
"""

import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests import models as tm
from tests.test_torch_kernel_source import TOL, _run_host
from tests.torch_port_helpers import (BALL, DROP, DROP_GEOMS, LIMITED,
                                      clearances, models_from_xml,
                                      pair_states, pair_xml)


def _host_and_plain(kern, qpos, qvel, values, aux, tmp_path, **kw):
  want = kern.plain(qpos, qvel, values, aux)
  want = list(want) if isinstance(want, tuple) else [want]
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos.contiguous(), qvel.contiguous(),
            values if values.numel() else torch.zeros(
                (1, qpos.shape[1]), dtype=torch.float64),
            aux, tmp_path, **kw)
  return got, want


def _ground_gaps(pm, rec, nq):
  """(steps, K) lowest ground clearance of each recorded state."""
  return np.stack([clearances(pm, rec[t, :nq].numpy())
                   for t in range(rec.shape[0])])


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("kind", ["capsule", "box"])
def test_cull_where_contacts_cross_zero_matches_plain(kind, cone, tmp_path):
  """A tilted capsule / box over the floor, 40 steps: some candidates fall
  onto it, some are pressed in and pushed up and off it, some stay clear;
  the rows that are culled change from step to step."""
  _, pm, mjm = models_from_xml(DROP.format(cone=cone, geom=DROP_GEOMS[kind]))
  kern = tstep.build_rollout_kernel(pm, 40, 1, _table_float=np.float64)
  rng = np.random.default_rng(11)
  k = 6
  qpos = np.tile(mjm.qpos0[:, None], (1, k))
  qpos[3:7] += 0.3 * rng.standard_normal((4, k))
  qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
  # lowest point 4 mm up, 1 mm up, 2 mm in, 3 mm in, 5 cm up, 4 mm up
  qpos[2] -= clearances(pm, qpos) - np.array(
      [0.004, 0.001, -0.002, -0.003, 0.05, 0.004])
  qvel = 0.2 * rng.standard_normal((pm.nv, k))
  qvel[2] = [-0.3, -0.1, 0.6, 0.9, 0.0, 0.4]
  qpos, qvel = torch.as_tensor(qpos), torch.as_tensor(qvel)
  values = torch.zeros((0, k), dtype=torch.float64)
  got, want = _host_and_plain(kern, qpos, qvel, values, None, tmp_path)
  gaps = _ground_gaps(pm, want[0], pm.nq)
  touching = gaps < 0
  # contacts switch on and off during the horizon, and one never touches
  assert (touching.any(0) & ~touching.all(0)).sum() >= 3, touching.T
  assert (~touching).all(0).any()
  assert torch.isfinite(want[0]).all()
  torch.testing.assert_close(got[0], want[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_every_row_active_spills_to_the_workspace(cone, tmp_path):
  """A capsule lying flat, both end points pressed into the floor and
  moving down, with a hinge-slide arm past its limits: every contact row
  is active in every step, and with the shared-memory caps cut to one row
  and no elliptic block all but one go through the global workspace."""
  _, pm, mjm = models_from_xml(DROP.format(
      cone=cone, geom=DROP_GEOMS["capsule"]))
  kern = tstep.build_rollout_kernel(pm, 6, 1, _row_cap=1, _blk_cap=0,
                                    _table_float=np.float64)
  defs = kern.build_defines()
  # one row (pyramidal: 8 rows, 4 an end point) or no block (elliptic: 2)
  assert (defs["LR_ROWCAP"], defs["LR_BLKCAP"]) == (
      (1, 0) if cone == "pyramidal" else (0, 0))
  assert defs["LR_NPROW"] + defs["LR_NECON"] == (8 if cone == "pyramidal"
                                                 else 2)
  rng = np.random.default_rng(12)
  k = 4
  qpos = np.tile(mjm.qpos0[:, None], (1, k))
  # level (the capsule's axis leaves the floor by 2 cm over 30 cm: roll it
  # flat about x), then 3-4 mm into the floor
  ang = np.arctan2(0.02, 0.3)
  qpos[3:7] = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0])[:, None]
  qpos[2] -= clearances(pm, qpos) + np.array([0.003, 0.0035, 0.004, 0.003])
  qvel = 0.02 * rng.standard_normal((pm.nv, k))
  qvel[2] = -0.3
  qpos, qvel = torch.as_tensor(qpos), torch.as_tensor(qvel)
  gaps = tstep.contact_gaps(pm, qpos)
  assert all((g < 0).all() for _, _, g in gaps)
  values = torch.zeros((0, k), dtype=torch.float64)
  got, want = _host_and_plain(kern, qpos, qvel, values, None, tmp_path)
  for t in range(want[0].shape[0]):
    for _, _, g in tstep.contact_gaps(pm, want[0][t, :pm.nq]):
      assert (g < 0).all(), t
  assert torch.isfinite(want[0]).all()
  torch.testing.assert_close(got[0], want[0], atol=TOL, rtol=TOL)

  # the limited chain, pushed past both of its joints' ranges
  _, lpm, lmjm = models_from_xml(LIMITED)
  lkern = tstep.build_rollout_kernel(lpm, 6, 1, _row_cap=1,
                                     _table_float=np.float64)
  lq = torch.as_tensor(np.array([[0.6, 0.62, -0.55, -0.6],
                                 [0.8, 0.75, -0.6, -0.7]]))
  lv = torch.as_tensor(np.array([[0.5, 0.1, -0.4, -0.2],
                                 [1.0, 0.5, -0.8, -0.3]]))
  got, want = _host_and_plain(lkern, lq, lv,
                              torch.zeros((lpm.nu, 4), dtype=torch.float64),
                              None, tmp_path)
  torch.testing.assert_close(got[0], want[0], atol=TOL, rtol=TOL)


def _quadruped_case(k):
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  terms = tuple(zip(cs.norm_types, cs.dims))
  kern = tstep.build_rollout_kernel(
      pt.plan_model, 4, 3, contact_types=(GEOM_SPHERE,),
      contact_geoms=pt.plan_contact_geoms, residual=spec, naux=spec["naux"],
      record_states=False, cost_terms=terms, _table_float=np.float64)
  rng = np.random.default_rng(13)
  d0 = pt.make_data()
  aux = torch.cat([spec["make_aux"](d0, pt.residual_params),
                   cs.norm_params[:, :2].reshape(-1)])
  aux = aux.double()[:, None].repeat(1, k).contiguous()
  qpos = d0.qpos.double()[:, None].repeat(1, k)
  qpos[2] += torch.as_tensor(0.01 * rng.standard_normal(k))
  qpos[7:] += torch.as_tensor(0.05 * rng.standard_normal((12, k)))
  qvel = torch.as_tensor(0.2 * rng.standard_normal((18, k)))
  home = torch.as_tensor(np.tile(pt.home_qpos[7:], 3))[:, None]
  values = (home + torch.as_tensor(0.1 * rng.standard_normal((36, k))))
  return kern, qpos.contiguous(), qvel, values.contiguous(), aux


def _humanoid_case(k):
  pt = tregistry.get_task("Humanoid Stand", device="cpu")
  spec = pt.lane_residual_spec()
  cs = pt.cost_spec
  kern = tstep.build_rollout_kernel(
      pt.plan_model, 3, 2, residual=spec, naux=spec["naux"],
      record_states=False, cost_terms=tuple(zip(cs.norm_types, cs.dims)),
      _table_float=np.float64)
  rng = np.random.default_rng(14)
  aux = torch.cat([spec["make_aux"](pt.make_data(), pt.residual_params),
                   cs.norm_params[:, :2].reshape(-1)])
  aux = aux.double()[:, None].repeat(1, k).contiguous()
  qpos = np.tile(np.asarray(pt.home_qpos)[:, None], (1, k))
  qpos[7:] += 0.05 * rng.standard_normal((21, k))
  qpos[2] -= clearances(pt.plan_model, qpos) + 0.001 * np.arange(1, k + 1)
  qvel = torch.as_tensor(0.1 * rng.standard_normal((27, k)))
  values = torch.as_tensor(rng.uniform(-0.5, 0.5, (2 * 21, k)))
  return kern, torch.as_tensor(qpos), qvel, values, aux


def _pair_case(k):
  _, pm, _ = models_from_xml(pair_xml("capsule_box", "pyramidal", 3, 1.0))
  kern = tstep.build_rollout_kernel(pm, 4, 1, body_pairs=True,
                                    _table_float=np.float64)
  qpos, qvel = pair_states("capsule_box", pm.nv, np.random.default_rng(15))
  values = torch.zeros((1, qpos.shape[1]), dtype=torch.float64)
  return kern, torch.as_tensor(qpos), torch.as_tensor(qvel), values, None


def _elliptic_case(k):
  _, pm, mjm = models_from_xml(BALL.format(cone="elliptic", condim=6,
                                           floor_condim=3, impratio=10.0))
  kern = tstep.build_rollout_kernel(pm, 6, 1, _row_cap=2, _blk_cap=0,
                                    _table_float=np.float64)
  rng = np.random.default_rng(16)
  qpos = torch.as_tensor(np.tile(mjm.qpos0[:, None], (1, k)))
  qpos[2] = torch.as_tensor(0.0995 + 0.002 * rng.standard_normal(k))
  qvel = torch.as_tensor(np.tile(
      np.array([0.8, 0, -0.5, 3.0, 0, 6.0])[:, None], (1, k)))
  qvel = qvel + torch.as_tensor(0.1 * rng.standard_normal((6, k)))
  return kern, qpos, qvel, torch.zeros((1, k), dtype=torch.float64), None


# (case, lanes a team): with 4 lanes every model here has more dofs than
# lanes (the Cholesky factorisations in shared memory); the ball (6 dofs)
# and the pair (7) at 8 lanes take the one-row-a-lane form in registers
THREADED = {"quadruped": (_quadruped_case, 4), "humanoid": (_humanoid_case, 4),
            "capsule_box_pair": (_pair_case, 4),
            "capsule_box_pair_row_a_lane": (_pair_case, 8),
            "elliptic_overflow": (_elliptic_case, 4),
            "elliptic_overflow_row_a_lane": (_elliptic_case, 8)}


@pytest.mark.parametrize("name", sorted(THREADED))
def test_four_lanes_as_threads_match_plain(name, tmp_path):
  """Four (or eight) lanes a team, each a host thread: the team's strided
  loops, barriers, ballot compaction, scans, xor-tree sums and the
  cooperative Cholesky factorisations give the plain version's result."""
  case, team = THREADED[name]
  k = 3
  kern, qpos, qvel, values, aux = case(k)
  if values.shape[1] != qpos.shape[1]:
    values = values[:, :qpos.shape[1]]
  want = kern.plain(qpos, qvel, values if aux is not None else values[:0],
                    aux)
  want = list(want) if isinstance(want, tuple) else [want]
  got = [torch.zeros_like(w) for w in want]
  _run_host(kern, got, qpos.contiguous(), qvel.contiguous(),
            values.contiguous(), aux, tmp_path, team=team)
  for g, w in zip(got, want):
    assert torch.isfinite(w).all()
    torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_non_finite_state_stays_non_finite(tmp_path):
  """A NaN velocity on one candidate of the ball on the floor: the cull
  keeps the NaN gap's rows (a NaN fails `>= 0`) and the candidate comes out
  NaN, as in the plain version; the others are untouched."""
  _, pm, mjm = models_from_xml(BALL.format(cone="pyramidal", condim=3,
                                           floor_condim=3, impratio=1.0))
  kern = tstep.build_rollout_kernel(pm, 5, 1, _table_float=np.float64)
  k = 3
  qpos = torch.as_tensor(np.tile(mjm.qpos0[:, None], (1, k)))
  qpos[2] = torch.as_tensor([0.0995, 0.3, 0.0995])
  qvel = torch.zeros((6, k), dtype=torch.float64)
  qvel[2, 1] = float("nan")       # airborne: every row culled but NaN
  qvel[0, 2] = float("inf")
  got, want = _host_and_plain(kern, qpos, qvel,
                              torch.zeros((0, k), dtype=torch.float64), None,
                              tmp_path)
  fin_got = torch.isfinite(got[0][-1]).all(dim=0)
  fin_want = torch.isfinite(want[0][-1]).all(dim=0)
  assert fin_want.tolist() == [True, False, False]
  assert torch.equal(fin_got, fin_want)
  torch.testing.assert_close(got[0][:, :, 0], want[0][:, :, 0], atol=TOL,
                             rtol=TOL)


def test_team_rule_and_teams_per_block():
  """The wrapper's launch rule: a power-of-two team inside one warp, and
  enough blocks for one on every SM within the block's thread and shared
  memory limits."""
  for nv, ncon in ((6, 8), (8, 0), (18, 4), (21, 230), (27, 39), (32, 78)):
    t = tstep.team_size(nv, ncon)
    assert t in (1, 2, 4, 8, 16, 32)
  smem = lambda teams: 1000 + 30000 * teams
  assert tstep.teams_per_block(512, 8, smem, 132) == 4
  assert tstep.teams_per_block(4096, 8, smem, 132) == 7     # shared memory
  assert tstep.teams_per_block(4096, 32, lambda n: 0, 132) == 8  # threads
  assert tstep.teams_per_block(10, 16, smem, 132) == 1


def test_gate_text_names_the_jax_class():
  """Models outside the kernel's class are refused as the JAX package
  refuses them, not as work still to be ported."""
  _, pm, _ = models_from_xml(tm.CHAIN)
  lossy = pm.replace(dof_frictionloss=torch.full((pm.nv,), 0.1))
  with pytest.raises(NotImplementedError) as err:
    tstep.build_rollout_kernel(lossy, 4, 1)
  msg = str(err.value)
  assert "as in the JAX package" in msg and "friction loss" in msg
  assert "not ported" not in msg
  assert "not ported" not in tstep.__doc__
  assert "outside the\nrollout kernel's class, as in the JAX package" in \
      tstep.__doc__
