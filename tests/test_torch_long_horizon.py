"""Port vs JAX over the planner's full horizon, standing on the floor.

Quadruped Flat from its home keyframe, candidates = home-pose nominal plus
0.04 exploration noise, 36 steps: the rollouts the planner scores. The JAX
side is `step_array` chained eagerly (one chain, shared by the tests).

The lane step is not a continuous function of its state: a fixed, short
Newton schedule over gated rows and cone zones turns a last-bit difference
into a different step now and then, and a standing robot with stiff
contacts amplifies it. Free-running rollouts of two correct float32
implementations therefore part candidate by candidate. So the tests hold

  * one step at a time from the JAX trajectory's own states (teacher
    forcing), per share of (step, candidate) pairs, beside a control: the
    port's step against itself with the state perturbed by 1e-7 relative;
  * the free-running rollouts in distribution: the share of candidates
    that go non-finite, and the share whose joint velocities spike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.physics import collision as jcoll
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.physics.model import GEOM_SPHERE
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import once_a_session, to_np, tt

K, P, H = 64, 3, 36
NQ, NV, NU = 19, 18, 12
TOL_STEP = 2e-4            # abs/rel, next state given the same state
TOL_STEP_MEDIAN = 1e-5     # median one-step error
TOL_STEP_SHARE = 0.08      # share of (step, candidate) pairs over TOL_STEP
TOL_VS_CONTROL = 1.5       # ... and at most this many times the control's
TOL_SHARE_DIFF = 0.2       # |share(JAX) - share(port)|, spikes, K=64
SPIKE = 100.0              # |qvel| beyond this is a spike


def _node(t):
  return min(int(t * P / max(H - 1, 1)), P - 1)


def _port_kernel(pt):
  pspec = pt.lane_residual_spec()
  pkern = tstep.build_rollout_kernel(
      pt.plan_model, H, P, contact_types=(GEOM_SPHERE,),
      contact_geoms=pt.plan_contact_geoms, residual=pspec,
      naux=pspec["naux"], record_states=True)
  paux = pspec["make_aux"](pt.make_data(), pt.residual_params)[:, None].repeat(
      1, K)
  return pkern, paux


def _compute_chains():
  """The JAX chain and the port's rollout of the same candidates, as numpy
  arrays."""
  jt = jregistry.get_task("Quadruped Flat")
  pt = tregistry.get_task("Quadruped Flat", device="cpu")
  rng = np.random.default_rng(0)
  lo = to_np(pt.plan_model.actuator_ctrlrange[:, 0])
  hi = to_np(pt.plan_model.actuator_ctrlrange[:, 1])
  home = np.asarray(pt.home_qpos[7:], np.float32)
  cand = home[None, None] + 0.04 * 0.5 * (hi - lo) * rng.standard_normal(
      (K, P, NU)).astype(np.float32)
  values = np.clip(cand, lo, hi).astype(np.float32).reshape(K, -1).T.copy()

  jspec = jt.lane_residual_spec()
  jkern = jstep.build_rollout_kernel(
      jt.plan_model, H, P, interpret=True, contact_types=(jcoll.SPHERE,),
      contact_geoms=jt.plan_contact_geoms, residual_fn=jspec["fn"],
      residual_dim=jspec["dim"], naux=jspec["naux"])
  jd0 = jt.make_data()
  jq = jnp.tile(jd0.qpos[:, None], (1, K))
  jv = jnp.tile(jd0.qvel[:, None], (1, K))
  jaux = jnp.tile(jspec["make_aux"](jd0, jt.residual_params)[:, None], (1, K))
  jax_states = [np.concatenate([np.asarray(jq), np.asarray(jv)])]
  with jax.disable_jit():
    for t in range(H):
      ctrl = jnp.asarray(values[_node(t) * NU:(_node(t) + 1) * NU])
      jq, jv, _ = jkern.step_array(jq, jv, ctrl, t, jaux)
      jax_states.append(np.concatenate([np.asarray(jq), np.asarray(jv)]))

  pkern, paux = _port_kernel(pt)
  pd0 = pt.make_data()
  rec = pkern(pd0.qpos[:, None].repeat(1, K), pd0.qvel[:, None].repeat(1, K),
              tt(values), paux)
  return dict(jax_states=np.stack(jax_states),       # (H+1, nq+nv, K)
              port_states=to_np(rec[:, :NQ + NV]),   # (H, nq+nv, K)
              values=values)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
  """The chains once a test session (~6 minutes of eager JAX steps), shared
  by the three tests however they are spread over workers; the port's
  kernel object is built in each process."""
  data = once_a_session(tmp_path_factory, "long_horizon_chains",
                        _compute_chains)
  pkern, paux = _port_kernel(tregistry.get_task("Quadruped Flat",
                                                device="cpu"))
  return dict(data, pkern=pkern, paux=paux)


def test_teacher_forced_steps_match_jax_over_the_full_horizon(chains):
  js, values = chains["jax_states"], chains["values"]
  pkern, paux = chains["pkern"], chains["paux"]
  gen = torch.Generator().manual_seed(0)

  def perturbed(x):
    return x * (1.0 + 1e-7 * torch.randn(x.shape, generator=gen))

  def rel_err(a, b):
    return ((a - b).abs() / torch.clamp(b.abs(), min=1.0)).amax(dim=0)

  err, ctl, sane = [], [], []
  for t in range(H):
    q, v = tt(js[t, :NQ]), tt(js[t, NQ:])
    ctrl = tt(values[_node(t) * NU:(_node(t) + 1) * NU])
    qn, vn, _ = pkern.step_array(q, v, ctrl, t, paux)
    qc, vc, _ = pkern.step_array(perturbed(q), perturbed(v), ctrl, t, paux)
    nxt = torch.cat([qn, vn])
    err.append(rel_err(tt(js[t + 1]), nxt))
    ctl.append(rel_err(torch.cat([qc, vc]), nxt))
    # blown-up states carry no meaningful float32 step: leave them out
    sane.append((q.abs().amax(dim=0) < 10.0) & (v.abs().amax(dim=0) < SPIKE))
  err, ctl = torch.stack(err), torch.stack(ctl)
  ok = torch.stack(sane) & torch.isfinite(err) & torch.isfinite(ctl)
  share = float((err[ok] > TOL_STEP).float().mean())
  share_ctl = float((ctl[ok] > TOL_STEP).float().mean())
  print(f"pairs {int(ok.sum())}/{ok.numel()} median {float(err[ok].median()):.3g}"
        f" share over {TOL_STEP}: vs JAX {share:.4f}, control {share_ctl:.4f}")
  assert float(ok.float().mean()) >= 0.9
  assert float(err[ok].median()) <= TOL_STEP_MEDIAN
  assert share <= TOL_STEP_SHARE
  assert share <= TOL_VS_CONTROL * share_ctl


def test_free_running_rollouts_blow_up_as_often_as_jax(chains):
  js, ps = chains["jax_states"][:H], chains["port_states"]

  def shares(states):
    nonfinite = ~np.isfinite(states).all(axis=(0, 1))
    vel = np.nan_to_num(np.abs(states[:, NQ:]), nan=np.inf)
    spike = (vel > SPIKE).any(axis=(0, 1))
    return float(nonfinite.mean()), float(spike.mean())

  (nf_j, sp_j), (nf_p, sp_p) = shares(js), shares(ps)
  print(f"non-finite share JAX {nf_j:.4f} port {nf_p:.4f}; "
        f"spike share JAX {sp_j:.4f} port {sp_p:.4f}")
  assert abs(nf_j - nf_p) <= 2.0 / K
  assert abs(sp_j - sp_p) <= TOL_SHARE_DIFF


def test_free_running_rollouts_start_out_equal_to_jax(chains):
  """Before the first gate flips, the two rollouts are the same rollout."""
  js, ps = chains["jax_states"], chains["port_states"]
  np.testing.assert_allclose(ps[:2], js[:2], atol=TOL_STEP, rtol=TOL_STEP)
  agree = (np.abs(ps[4] - js[4]) <= TOL_STEP * np.maximum(
      1.0, np.abs(js[4]))).all(axis=0)
  assert agree.mean() >= 0.5, agree.mean()
