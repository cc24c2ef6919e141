"""The port's iLQG planner against the JAX package's, on the CPU.

  * `lanemath.quat_sub_tangent` vs the JAX one (1e-5);
  * the lane feedback rollouts (`_make_lane_feedback`, on the CPU the plain
    version of the rollout kernel in its feedback mode, with fluid) vs the
    same line search made of the JAX package's pieces — its lane
    `step_array`, its tangent `state_diff`, its cost — and vs the port's own
    pipeline `feedback_rollout`: 2e-4 on states, 1e-3 abs on actions, 1e-3
    rel on returns (the JAX suite's bars for lane vs pipeline);
  * one and two chained `optimize` iterations on Cartpole and Swimmer at
    horizon 6 against the JAX `ILQGPlanner`: `nominal_return` /
    `best_return` 1e-3 rel and actions 1e-3 abs, the bars of
    tests/test_ops.py for lane vs pipeline iLQG; then one more iteration of
    each from the SAME policy (the JAX one carried across by
    `convert.ilqg_policy_from_numpy`);
  * behaviour: the port's own iLQG lowers Cartpole's cost.

The JAX planner runs as the JAX package runs it on a CPU (jitted pipeline
rollouts and the XLA reverse scan); the Pallas feedback kernel in
interpret mode takes a quarter of an hour at Swimmer's size and is not
used here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import lanemath as jlm
from mujoco_mpc_tpu.ops import step_lane as jstep
from mujoco_mpc_tpu.planners import derivatives as JD
from mujoco_mpc_tpu.planners import ilqg as jilqg
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import lanemath as tlm
from mujoco_mpc_tpu_torch.ops import riccati_lane as triccati
from mujoco_mpc_tpu_torch.ops import step_lane as tstep
from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np, tt

H = 6
START = {"Cartpole": [0.1, 2.6], "Swimmer": None}


def test_quat_sub_tangent_matches_jax():
  rng = np.random.default_rng(0)
  qa = rng.standard_normal((4, 32)).astype(np.float32)
  qb = rng.standard_normal((4, 32)).astype(np.float32)
  qa /= np.linalg.norm(qa, axis=0)
  qb /= np.linalg.norm(qb, axis=0)
  qb[:, :4] = qa[:, :4]          # zero rotation
  qb[:, 4:8] = -qa[:, 4:8]       # the same rotation, other sign
  got = tlm.quat_sub_tangent(tuple(tt(qa)), tuple(tt(qb)))
  want = jlm.quat_sub_tangent(list(jnp.asarray(qa)), list(jnp.asarray(qb)))
  for g, w in zip(got, want):
    np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5)
  assert float(torch.stack(got)[:, :8].abs().max()) < 1e-5


def _policy_pair(jt, pt, horizon, seed):
  """A non-trivial policy (random nominal controls, gains and k) as the JAX
  pytree leaves and as the port's policy."""
  m = jt.plan_model
  rng = np.random.default_rng(seed)
  d0 = jt.make_data()
  nx = 2 * m.nv
  state0 = np.concatenate([np.asarray(d0.qpos), np.asarray(d0.qvel)])
  leaves = dict(
      states=(state0[None] + 0.05 * rng.standard_normal(
          (horizon, m.nq + m.nv))).astype(np.float32),
      actions=rng.uniform(-0.6, 0.6, (horizon, m.nu)).astype(np.float32),
      times=(0.01 * np.arange(horizon)).astype(np.float32),
      gains=(0.5 * rng.standard_normal((horizon, m.nu, nx))).astype(
          np.float32),
      reg=np.float32(1e-2), reg_rate=np.float32(1.0))
  ks = (0.3 * rng.standard_normal((horizon - 1, m.nu))).astype(np.float32)
  return leaves, convert.ilqg_policy_from_numpy(**leaves, device="cpu"), ks


def test_lane_feedback_rollouts_match_jax_pieces_and_the_pipeline():
  jt = jregistry.get_task("Swimmer")
  pt = tregistry.get_task("Swimmer", device="cpu")
  jm, pm = jt.plan_model, pt.plan_model
  horizon, kc = 5, 4
  leaves, pol, ks = _policy_pair(jt, pt, horizon, seed=1)
  alphas = np.array([1.0, 0.3, 0.05, 0.0], np.float32)
  scales = np.array([1.0, 1.0, 0.4, 0.0], np.float32)
  kmats = leaves["gains"][:-1]

  # ---- the port: lane rollouts (plain version on the CPU) ----
  spec = pt.lane_residual_spec()
  before = tstep.launch_count
  fb = tilqg._make_lane_feedback(pm, spec, horizon)
  d0 = pt.make_data()
  states, actions, totals = fb(d0, pol.states, pol.actions, tt(ks),
                               tt(kmats), tt(alphas), tt(scales),
                               pt.residual_params, pt.cost_spec)
  assert tstep.launch_count == before       # CPU tensors launch nothing
  assert states.shape == (kc, horizon, pm.nq + pm.nv)
  assert actions.shape == (kc, horizon, pm.nu) and totals.shape == (kc,)

  # ---- the same line search from the JAX package's pieces ----
  jspec = jt.lane_residual_spec()
  jkern = jstep.build_rollout_kernel(
      jm, horizon, 1, interpret=True, contact_types=(),
      residual_fn=jspec["fn"], residual_dim=jspec["dim"], naux=jspec["naux"])
  jstep_fn = jax.jit(jkern.step_array)
  jd0 = jt.make_data()
  aux = jnp.tile(jspec["make_aux"](jd0, jt.residual_params)[:, None],
                 (1, kc))
  lo = np.asarray(jm.actuator_ctrlrange[:, 0])
  hi = np.asarray(jm.actuator_ctrlrange[:, 1])
  k_pad = np.concatenate([ks, np.zeros((1, jm.nu), np.float32)])
  km_pad = np.concatenate([kmats, np.zeros((1, jm.nu, 2 * jm.nv),
                                           np.float32)])
  qp = jnp.tile(jd0.qpos[:, None], (1, kc))
  qv = jnp.tile(jd0.qvel[:, None], (1, kc))
  jstates, jactions, jres = [], [], []
  for t in range(horizon):
    x = np.concatenate([np.asarray(qp), np.asarray(qv)]).T     # (K, S)
    dx = np.stack([np.asarray(JD.state_diff(
        jm, jnp.asarray(x[c]), jnp.asarray(leaves["states"][t])))
                   for c in range(kc)])
    u = (leaves["actions"][t][None] + alphas[:, None] * k_pad[t][None] +
         scales[:, None] * (dx @ km_pad[t].T))
    u = np.clip(u, lo, hi).astype(np.float32)
    qp2, qv2, res = jstep_fn(qp, qv, jnp.asarray(u.T),
                             jnp.asarray(t, jnp.int32), aux)
    jstates.append(x)
    jactions.append(u)
    jres.append(np.asarray(res).T)
    qp, qv = qp2, qv2
  jstates = np.stack(jstates, axis=1)
  jactions = np.stack(jactions, axis=1)
  jtotals = np.asarray(jnp.sum(jt.cost_spec.cost(
      jnp.asarray(np.stack(jres, axis=1))), axis=1)) / horizon
  np.testing.assert_allclose(to_np(states), jstates, atol=2e-4)
  np.testing.assert_allclose(to_np(actions), jactions, atol=1e-3)
  np.testing.assert_allclose(to_np(totals), jtotals, rtol=1e-3)
  assert np.ptp(jtotals) > 1e-4             # the candidates do differ

  # ---- the port's pipeline feedback rollouts ----
  planner = tilqg.ILQGPlanner(
      pt, tilqg.make_config(pt).replace(horizon=horizon), lane=False,
      device="cpu")
  # reach the pipeline route through the planner's own optimize function:
  # its nominal line search rolls out exactly these candidates
  cfg = planner.config.replace(num_fb_scales=kc, num_alphas=2)
  opt = tilqg.make_optimize_fn(pm, lambda m, d: pt.residual(
      m, d, pt.residual_params), pt.cost_spec.cost, pt.cost_spec, cfg)
  _, info = opt(None, d0, pol)
  # scales of that search are the log scale (1, .., 1e-3, 0) with alpha 0:
  lane_nom = fb(d0, pol.states, pol.actions, torch.zeros(horizon - 1, pm.nu),
                pol.gains[:-1], torch.zeros(kc),
                torch.cat([torch.logspace(0, -3, kc - 1), torch.zeros(1)]),
                pt.residual_params, pt.cost_spec)[2]
  np.testing.assert_allclose(float(info["nominal_return"]),
                             float(lane_nom.min()), rtol=1e-3)


@pytest.fixture(scope="module")
def planner_sets():
  """name -> the JAX planner after two iterations and the port's planners,
  built once per task for the whole file."""
  built = {}

  def get(name):
    if name not in built:
      built[name] = _build_planners(name)
    return built[name]

  return get


def _build_planners(name):
  jt = jregistry.get_task(name)
  pt = tregistry.get_task(name, device="cpu")
  jcfg = jilqg.make_config(jt).replace(horizon=H, num_alphas=4,
                                       num_fb_scales=3)
  pcfg = tilqg.make_config(pt).replace(horizon=H, num_alphas=4,
                                       num_fb_scales=3)
  assert dataclass_dict(pcfg) == {k: getattr(jcfg, k)
                                  for k in dataclass_dict(pcfg)}
  jd0, pd0 = jt.make_data(), pt.make_data()
  if START[name] is not None:
    jd0 = jd0.replace(qpos=jnp.asarray(START[name], jnp.float32))
    pd0 = pd0.replace(qpos=tt(START[name]))
  jp = jilqg.ILQGPlanner(jt, jcfg, lane=False)
  lanes = [False, True] if hasattr(pt, "lane_residual_spec") else [False]
  pps = {lane: tilqg.ILQGPlanner(pt, pcfg, lane=lane, device="cpu")
         for lane in lanes}
  jinfos, jpols = [], []
  for _ in range(2):
    jinfos.append(jp.optimize(jax.random.PRNGKey(0), jd0))
    jpols.append(jp.policy)
  return dict(name=name, jp=jp, pps=pps, jd0=jd0, pd0=pd0, jinfos=jinfos,
              jpols=jpols, pt=pt)


def dataclass_dict(cfg):
  import dataclasses
  return dataclasses.asdict(cfg)


def _leaves(jpol):
  return dict(states=np.asarray(jpol.states), actions=np.asarray(jpol.actions),
              times=np.asarray(jpol.times), gains=np.asarray(jpol.gains),
              reg=np.asarray(jpol.reg), reg_rate=np.asarray(jpol.reg_rate))


@pytest.mark.parametrize("name,lane", [("Cartpole", False),
                                       ("Swimmer", False),
                                       ("Swimmer", True)])
def test_two_chained_iterations_match_jax(planner_sets, name, lane):
  planners = planner_sets(name)
  pp = planners["pps"][lane]
  assert (pp.lane_spec is not None) == lane
  before = (tstep.launch_count, triccati.launch_count)
  for it in range(2):
    info = pp.optimize(None, planners["pd0"])
    jinfo = planners["jinfos"][it]
    for key in ("nominal_return", "best_return"):
      np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                                 rtol=1e-3, err_msg=f"{key} it={it}")
    assert bool(info["backward_ok"]) == bool(jinfo["backward_ok"])
    assert bool(info["improved"]) == bool(jinfo["improved"])
    np.testing.assert_allclose(float(info["alpha"]), float(jinfo["alpha"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(info["reg"]), float(jinfo["reg"]),
                               rtol=1e-5)
    assert info["host_readbacks"] == info["backward_sweeps"] == 1
    jpol = planners["jpols"][it]
    # the lane route keeps the previous policy's last action where the
    # pipeline route repeats the one before it (in the JAX package alike:
    # planners/ilqg.py:345 against :448), so the last row is left out there
    rows = slice(0, H - 1) if lane else slice(0, H)
    np.testing.assert_allclose(to_np(pp.policy.actions)[rows],
                               np.asarray(jpol.actions)[rows], atol=1e-3)
    np.testing.assert_allclose(to_np(pp.policy.states),
                               np.asarray(jpol.states), atol=1e-3)
  assert (tstep.launch_count, triccati.launch_count) == before
  assert float(info["best_return"]) < float(planners["jinfos"][0][
      "nominal_return"])
  # the policy's action with state feedback
  jp = planners["jp"]
  state = np.asarray(jp.policy.states[2]) + 0.01
  np.testing.assert_allclose(
      to_np(pp.action(0.021, tt(state))),
      np.asarray(jp.action(0.021, jnp.asarray(state))), atol=2e-3)


@pytest.mark.parametrize("name", ["Cartpole", "Swimmer"])
def test_one_iteration_from_the_jax_policy_matches_jax(planner_sets, name):
  """Policies carried across by convert: both planners take their third
  iteration from the JAX planner's second policy."""
  planners = planner_sets(name)
  jp, pd0 = planners["jp"], planners["pd0"]
  pp = planners["pps"][False]
  pp.policy = convert.ilqg_policy_from_numpy(**_leaves(planners["jpols"][1]),
                                             device="cpu")
  info = pp.optimize(None, pd0)
  jinfo = jp.optimize(jax.random.PRNGKey(0), planners["jd0"])
  for key in ("nominal_return", "best_return"):
    np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                               rtol=1e-3, err_msg=key)
  np.testing.assert_allclose(to_np(pp.policy.actions),
                             np.asarray(jp.policy.actions), atol=1e-3)
  np.testing.assert_allclose(to_np(pp.policy.gains),
                             np.asarray(jp.policy.gains), atol=2e-3,
                             rtol=1e-3)


def test_ilqg_lowers_cartpole_cost():
  pt = tregistry.get_task("Cartpole", device="cpu")
  cfg = tilqg.make_config(pt).replace(horizon=12)
  planner = tilqg.ILQGPlanner(pt, cfg, device="cpu")
  assert planner.lane_spec is None       # the CPU never takes the kernels
  d0 = pt.make_data().replace(qpos=tt([0.1, 2.6]))
  infos = [planner.optimize(None, d0) for _ in range(4)]
  first = float(infos[0]["nominal_return"])
  last = float(infos[-1]["best_return"])
  assert np.isfinite(last) and last < 0.99 * first, (first, last)
  for a, b in zip(infos, infos[1:]):
    assert float(b["nominal_return"]) <= float(a["best_return"]) * (1 + 1e-5)
  assert planner.action(0.0).shape == (1,)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tilqg.ILQGPlanner(pt, cfg)             # default device is "cuda"


def _refused(case):
  """(task, config, constructor arguments, message) of a planner that a
  kernel's gate refuses."""
  cart = tregistry.get_task("Cartpole", device="cpu")
  swim = tregistry.get_task("Swimmer", device="cpu")
  cart_cfg = tilqg.make_config(cart).replace(horizon=6)
  swim_cfg = tilqg.make_config(swim).replace(horizon=6)
  return {
      "task_without_a_lane_residual": (
          cart, cart_cfg, {}, "no lane_residual_spec"),
      "horizon_outside_the_riccati_gate": (
          swim, swim_cfg.replace(horizon=513), {}, "Riccati kernel's gate"),
      "riccati_gate_with_pipeline_rollouts": (
          cart, cart_cfg.replace(horizon=513), dict(lane=False),
          "Riccati kernel's gate"),
  }[case]


@pytest.mark.parametrize("case", ["task_without_a_lane_residual",
                                  "horizon_outside_the_riccati_gate",
                                  "riccati_gate_with_pipeline_rollouts"])
def test_on_a_cuda_device_a_refused_kernel_raises(monkeypatch, case):
  """With the device's tensors on a card the planner never gives way to a
  plain version by itself: a gate that refuses raises and names itself.
  The CPU stands in for the card here through the planner's one device
  test."""
  task, cfg, kw, message = _refused(case)
  monkeypatch.setattr(tilqg, "_on_card", lambda device: True)
  with pytest.raises(NotImplementedError, match=message):
    tilqg.ILQGPlanner(task, cfg, device="cpu", **kw)


def test_make_optimize_fn_on_a_cuda_device_needs_a_route(monkeypatch):
  cart = tregistry.get_task("Cartpole", device="cpu")
  cfg = tilqg.make_config(cart).replace(horizon=6)
  args = (cart.plan_model, lambda m, d: cart.residual(
      m, d, cart.residual_params), cart.cost_spec.cost, cart.cost_spec, cfg)
  assert tilqg.make_optimize_fn(*args).routes == dict(
      line_search="plain", backward="plain")          # the CPU's defaults
  monkeypatch.setattr(tilqg, "_on_card", lambda device: True)
  with pytest.raises(NotImplementedError, match="lane_spec=False"):
    tilqg.make_optimize_fn(*args)
  opt = tilqg.make_optimize_fn(*args, lane_spec=False)
  assert opt.routes == dict(line_search="plain", backward="kernel")


@pytest.mark.parametrize("on_card,kw,routes", [
    (False, {}, ("plain", "plain")),
    (False, dict(lane=True, riccati_lane_mode=True), ("kernel", "kernel")),
    (True, {}, ("kernel", "kernel")),
    (True, dict(lane=False), ("plain", "kernel")),
    (True, dict(lane=False, riccati_lane_mode=False), ("plain", "plain")),
])
def test_planner_says_which_routes_it_took(monkeypatch, on_card, kw, routes):
  swim = tregistry.get_task("Swimmer", device="cpu")
  cfg = tilqg.make_config(swim).replace(horizon=6)
  monkeypatch.setattr(tilqg, "_on_card", lambda device: on_card)
  planner = tilqg.ILQGPlanner(swim, cfg, device="cpu", **kw)
  assert planner.routes == dict(line_search=routes[0], backward=routes[1])
  assert (planner.lane_spec is not None) == (routes[0] == "kernel")


def test_lane_kernel_asked_for_by_name_raises_where_refused():
  cart = tregistry.get_task("Cartpole", device="cpu")
  cfg = tilqg.make_config(cart).replace(horizon=6)
  with pytest.raises(NotImplementedError, match="lane=False"):
    tilqg.ILQGPlanner(cart, cfg, device="cpu", lane=True)


def test_optimize_marks_its_stages():
  cart = tregistry.get_task("Cartpole", device="cpu")
  planner = tilqg.ILQGPlanner(
      cart, tilqg.make_config(cart).replace(horizon=6), device="cpu")
  stages = []
  info = planner.optimize(None, cart.make_data(), mark=stages.append)
  assert stages == ["start", "nominal_line_search", "derivatives",
                    "backward", "action_line_search"]
  assert "stage_events" not in info
