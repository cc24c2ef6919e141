"""Port vs JAX: the agent loop (Agent, the Task API it calls, testspeed).

The JAX side runs once a test session (`torch_port_helpers.once_a_session`)
on Cartpole (RK4) and Swimmer (Euler, fluid): five `step_env` calls with
the same actions from the same state, the cost `run` records after each,
one `plan_iteration` of the pipeline sampling planner (K=6, H=20) whose
noise is recomputed from the JAX agent's key and given to the port, the
name-based setters, and Swimmer's target teleport. Its physics step is
jitted with the control as an argument, so that it does not compile the
same computation as the other test files that step these tasks.

Tolerances: ROADMAP's, 2e-4 on states, 5e-4 on costs and returns; the
setters' dicts and the teleported target exactly (the same float32
arithmetic on the host).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch import testspeed
from mujoco_mpc_tpu_torch.agent import agent as tagent
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import (jax_state, once_a_session,
                                      port_data_with_jax_state, to_np, tt)

TOL_STATE = 2e-4
TOL_COST = 5e-4
K, H = 6, 20
STEPS = 5
SEED = 3
TASKS = ("Cartpole", "Swimmer")


def _jax_runs() -> dict:
  import jax
  import jax.numpy as jnp

  from mujoco_mpc_tpu.agent.agent import Agent
  from mujoco_mpc_tpu.physics import forward as JF
  from mujoco_mpc_tpu.planners import sampling as jsampling
  from mujoco_mpc_tpu.tasks import registry as jregistry

  out = {}
  for name in TASKS:
    jt = jregistry.get_task(name)
    agent = Agent(jt, seed=SEED)
    jm = agent.m
    step = jax.jit(lambda d, u: JF.step(jm, d.replace(ctrl=u)))
    agent._step = lambda d: step(d, d.ctrl)
    # start from a Data with every derived field present (zeros, recomputed
    # by the step), so that the step compiles once, not once for the fresh
    # Data's structure and again for a stepped one's
    full = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        jax.eval_shape(step, agent.data, agent.data.ctrl))
    agent.data = full.replace(**{
        f.name: getattr(agent.data, f.name)
        for f in dataclasses.fields(agent.data)
        if getattr(agent.data, f.name) is not None})
    rng = np.random.default_rng(SEED)
    home = np.asarray(agent.data.qpos)
    agent.data = agent.data.replace(
        qpos=jnp.asarray(home + 0.1 * rng.standard_normal(home.shape),
                         jnp.float32),
        qvel=jnp.asarray(0.3 * rng.standard_normal(jm.nv), jnp.float32))
    for f, v in jax_state(agent.data).items():
      out[f"{name}/start/{f}"] = v
    lo, hi = np.asarray(jm.actuator_ctrlrange).T
    actions = rng.uniform(lo, hi, (STEPS, jm.nu)).astype(np.float32)
    out[f"{name}/actions"] = actions
    states, costs = [], []
    for u in actions:
      agent.step_env(jnp.asarray(u))
      d = agent.data
      states.append(np.concatenate([np.asarray(d.qpos), np.asarray(d.qvel),
                                    np.asarray(d.time)[None]]))
      costs.append(float(jt.cost(jt.residual(jm, d, jt.residual_params))))
    out[f"{name}/states"] = np.array(states)
    out[f"{name}/costs"] = np.array(costs)

    # one plan iteration from there, its noise recomputed from the key
    cfg = jsampling.make_config(jt).replace(num_trajectory=K, horizon=H)
    agent.planner = jsampling.SamplingPlanner(jt, cfg)
    _, sub = jax.random.split(agent.key)
    kb, kn = jax.random.split(sub)
    p, nu = agent.planner.policy.values.shape
    out[f"{name}/plan/u"] = np.asarray(jax.random.uniform(kb, (K - 1,)))
    out[f"{name}/plan/noise"] = np.asarray(
        jax.random.normal(kn, (K - 1, p, nu)))
    for f, v in jax_state(agent.data).items():
      out[f"{name}/plan/{f}"] = v
    info = agent.plan_iteration()
    out[f"{name}/plan/returns"] = np.asarray(info["returns"])
    out[f"{name}/plan/winner"] = np.asarray(info["winner"])
    out[f"{name}/plan/values"] = np.asarray(agent.planner.policy.values)

    if name == "Swimmer":
      # the target within 0.04 of the nose: teleported on this step, from
      # the global numpy RNG the JAX task draws from
      d = agent.data
      near = np.asarray(d.mocap_pos).copy()
      near[0, :2] = np.asarray(d.xpos[1, :2]) + 0.01
      agent.data = d.replace(mocap_pos=jnp.asarray(near))
      for f, v in jax_state(agent.data).items():
        out[f"{name}/near/{f}"] = v
      np.random.seed(SEED)
      agent.step_env(jnp.zeros(jm.nu))
      out[f"{name}/near/new_mocap_pos"] = np.asarray(agent.data.mocap_pos)
      agent.step_env(jnp.zeros(jm.nu))       # far now: stays
      out[f"{name}/near/after_far_step"] = np.asarray(agent.data.mocap_pos)

    if name == "Cartpole":
      out["setters/weights_default"] = _weights(agent)
      agent.set_cost_weight("Vertical", 3.5)
      agent.set_cost_weight("Control", 0.25)
      agent.set_task_parameter("Goal", 0.4)
      out["setters/weights"] = _weights(agent)
      out["setters/params"] = np.asarray(jt.residual_params)
      out["setters/task_parameters"] = np.array(
          [agent.get_task_parameters()["Goal"]])
      terms = agent.get_cost_term_values()
      out["setters/term_values"] = np.array(
          [terms[n] for n in jt.cost_spec.term_names])
      agent.reset_cost_weights()
      out["setters/weights_reset"] = _weights(agent)

  jq = jregistry.get_task("Quadruped Flat")
  qagent = Agent(jq)
  out["quadruped/gait_options"] = np.array(jq.selection_options("Gait"))
  qagent.set_task_parameter_selection("Gait", "Trot")
  qagent.set_mode("Biped")
  out["quadruped/params"] = np.asarray(jq.residual_params)
  out["quadruped/mode"] = np.array(qagent.get_mode())
  return out


def _weights(agent) -> np.ndarray:
  w = agent.get_cost_weights()
  return np.array([w[n] for n in agent.task.cost_spec.term_names],
                  np.float32)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
  return once_a_session(tmp_path_factory, "torch_agent_jax_runs", _jax_runs)


def _port_agent(name, state=None, **kw):
  pt = tregistry.get_task(name, device="cpu")
  agent = tagent.Agent(pt, seed=SEED, **kw)
  if state is not None:
    agent.data = port_data_with_jax_state(agent.data, state)
  return agent


def _state(runs, prefix):
  return {f: runs[f"{prefix}/{f}"] for f in
          ("qpos", "qvel", "mocap_pos", "time")}


@pytest.mark.parametrize("name", TASKS)
def test_step_env_and_run_cost_match_jax(jax_runs, name):
  """Five step_env calls with the same actions from the same state:
  qpos, qvel and time after each step to 2e-4, the cost `run` records to
  5e-4."""
  agent = _port_agent(name, _state(jax_runs, f"{name}/start"))
  pt = agent.task
  nq = pt.model.nq
  for t, u in enumerate(jax_runs[f"{name}/actions"]):
    agent.step_env(tt(u))
    d = agent.data
    want = jax_runs[f"{name}/states"][t]
    np.testing.assert_allclose(to_np(d.qpos), want[:nq], atol=TOL_STATE,
                               err_msg=f"qpos t={t}")
    np.testing.assert_allclose(to_np(d.qvel), want[nq:-1], atol=TOL_STATE,
                               err_msg=f"qvel t={t}")
    np.testing.assert_allclose(float(d.time), want[-1], atol=TOL_STATE)
    cost = float(pt.cost(pt.residual(pt.model, d, pt.residual_params)))
    np.testing.assert_allclose(cost, jax_runs[f"{name}/costs"][t],
                               rtol=TOL_COST, atol=TOL_COST)


def test_swimmer_transition_teleports_the_target_like_jax(jax_runs):
  """The target within 0.04 of the nose: both packages teleport it on the
  same step, to the same point (the JAX task draws from the global numpy
  RNG seeded with s, the port's from the agent's generator, here a
  RandomState(s)); on the next step, away from the target, neither moves
  it."""
  agent = _port_agent("Swimmer", _state(jax_runs, "Swimmer/near"))
  agent.rng = np.random.RandomState(SEED)
  before = to_np(agent.data.mocap_pos)
  agent.step_env(torch.zeros(agent.m.nu))
  moved = to_np(agent.data.mocap_pos)
  assert not np.array_equal(moved, before)
  np.testing.assert_array_equal(moved, jax_runs["Swimmer/near/new_mocap_pos"])
  agent.step_env(torch.zeros(agent.m.nu))
  np.testing.assert_array_equal(to_np(agent.data.mocap_pos), moved)
  np.testing.assert_array_equal(jax_runs["Swimmer/near/after_far_step"],
                                jax_runs["Swimmer/near/new_mocap_pos"])


@pytest.mark.parametrize("name", TASKS)
def test_plan_iteration_with_injected_noise_matches_jax(jax_runs, name):
  """One plan_iteration of the pipeline sampling planner (neither agent
  takes the lane route on a CPU) with the JAX agent's noise: the returns
  and the new policy to 5e-4, the same winner."""
  agent = _port_agent(name, _state(jax_runs, f"{name}/plan"))
  assert agent.routes["planner"] == "SamplingPlanner"
  assert not agent.routes["lane_eligible"]
  cfg = dataclasses.replace(tsampling.make_config(agent.task),
                            num_trajectory=K, horizon=H)
  agent.planner = tsampling.SamplingPlanner(agent.task, cfg, device="cpu")
  info = agent.plan_iteration(noise=tt(jax_runs[f"{name}/plan/noise"]),
                              u=tt(jax_runs[f"{name}/plan/u"]))
  np.testing.assert_allclose(to_np(info["returns"]),
                             jax_runs[f"{name}/plan/returns"],
                             rtol=TOL_COST, atol=TOL_COST)
  assert int(info["winner"]) == int(jax_runs[f"{name}/plan/winner"])
  np.testing.assert_allclose(to_np(agent.planner.policy.values),
                             jax_runs[f"{name}/plan/values"], atol=TOL_COST)


def test_name_based_setters_match_jax(jax_runs):
  """Cost weights, task parameters and cost term values after the same
  setter calls; selections and modes by name on Quadruped Flat."""
  agent = _port_agent("Cartpole", _state(jax_runs, "Cartpole/plan"))
  agent.data = agent.data.replace(ctrl=tt(jax_runs["Cartpole/actions"][-1]))
  np.testing.assert_array_equal(_weights(agent),
                                jax_runs["setters/weights_default"])
  agent.set_cost_weight("Vertical", 3.5)
  agent.set_cost_weight("Control", 0.25)
  agent.set_task_parameter("Goal", 0.4)
  np.testing.assert_array_equal(_weights(agent), jax_runs["setters/weights"])
  np.testing.assert_array_equal(to_np(agent.task.residual_params),
                                jax_runs["setters/params"])
  assert agent.get_task_parameters() == {
      "Goal": float(jax_runs["setters/task_parameters"][0])}
  terms = agent.get_cost_term_values()
  np.testing.assert_allclose(
      [terms[n] for n in agent.task.cost_spec.term_names],
      jax_runs["setters/term_values"], rtol=TOL_COST, atol=TOL_COST)
  agent.reset_cost_weights()
  np.testing.assert_array_equal(_weights(agent),
                                jax_runs["setters/weights_reset"])
  with pytest.raises(KeyError):
    agent.set_task_parameter("NoSuchParameter", 1.0)

  quad = _port_agent("Quadruped Flat", planner="Sampling Lane")
  assert quad.task.selection_options("Gait") == list(
      jax_runs["quadruped/gait_options"])
  quad.set_task_parameter_selection("Gait", "Trot")
  quad.set_mode("Biped")
  np.testing.assert_array_equal(to_np(quad.task.residual_params),
                                jax_runs["quadruped/params"])
  assert quad.get_mode() == str(jax_runs["quadruped/mode"]) == "Biped"
  assert quad.get_all_modes()[:2] == ["Quadruped", "Biped"]


@pytest.mark.parametrize("name", ["Cartpole", "Swimmer", "Quadruped Flat"])
def test_lane_eligibility_is_a_pure_function_of_device_task_and_mode(name):
  pt = tregistry.get_task(name, device="cpu")
  assert tagent.lane_eligibility(pt, "cuda") == (True, "eligible")
  ok, reason = tagent.lane_eligibility(pt, "cpu")
  assert not ok and "device=cpu" in reason
  if name == "Quadruped Flat":
    pt.set_mode_by_name("Biped")
    ok, reason = tagent.lane_eligibility(pt, "cuda")
    assert not ok and "lane_modes" in reason and "Biped" in reason


def test_stated_refusals_name_their_roadmap_items():
  """Quadruped Flat on the CPU: the pipeline sampler refuses its contacts
  at construction. With the lane planner it builds, and step_env refuses
  the simulation model naming contacts. The HTML export names its queue
  item; an unknown estimator is refused by name (the filters build since
  they were ported, tests/test_torch_agent_estimator.py)."""
  quad = tregistry.get_task("Quadruped Flat", device="cpu")
  with pytest.raises(NotImplementedError, match="contacts"):
    tagent.Agent(quad, device="cpu")
  agent = tagent.Agent(quad, planner="Sampling Lane", device="cpu")
  assert agent.routes["planner"] == "LaneSamplingPlanner"
  with pytest.raises(NotImplementedError, match="contacts.*items 3-4"):
    agent.step_env()
  with pytest.raises(NotImplementedError, match="queue 1 item 7"):
    agent.save_trajectory_html("x.html")
  cart = tregistry.get_task("Cartpole", device="cpu")
  with pytest.raises(ValueError, match="unknown estimator"):
    tagent.Agent(cart, estimator="Oracle")


def test_testspeed_runs_on_the_cpu_and_returns_the_reference_keys():
  """testspeed.run on the CPU: the JAX module's keys (mujoco_mpc_tpu/
  testspeed.py), finite. The lane planner's plain version plans here (the
  pipeline planner takes ~17 s an iteration at Cartpole's K=10, H=101)."""
  out = testspeed.run("Cartpole", total_time=0.2,
                      steps_per_planning_iteration=20,
                      planner="Sampling Lane", verbose=False, device="cpu")
  keys = ("task", "planner", "total_time", "wall_time", "realtime_factor",
          "avg_cost", "plan_time_p50")
  assert set(keys) <= set(out)
  assert out["task"] == "Cartpole" and out["planner"] == "Sampling Lane"
  for k in keys[2:]:
    assert np.isfinite(out[k]), (k, out[k])
  run = out["run"]
  assert run["costs"].shape == (20,) and len(run["plan_times"]) == 1
  assert run["states"].shape == (20, 4) and np.isfinite(run["states"]).all()
  assert out["routes"]["planner"] == "LaneSamplingPlanner"


def test_state_snapshot_matches_jax():
  """agent/state.py: the port's State reads a Data's tensors back from
  their device and holds what the JAX package's State holds for the same
  numbers."""
  import types

  from mujoco_mpc_tpu.agent import state as jstate
  from mujoco_mpc_tpu_torch.agent import state as tstate
  pt = tregistry.get_task("Swimmer", device="cpu")
  m = pt.model
  rng = np.random.default_rng(SEED)
  d = pt.make_data()
  d = d.replace(qpos=tt(rng.standard_normal(m.nq)),
                qvel=tt(rng.standard_normal(m.nv)),
                mocap_pos=tt(rng.standard_normal((m.nmocap, 3))),
                time=tt(0.37))
  host = types.SimpleNamespace(**{f: to_np(getattr(d, f)) for f in (
      "qpos", "qvel", "act", "mocap_pos", "mocap_quat", "userdata", "time")})
  args = (m.nq, m.nv, m.na, m.nmocap, m.nuserdata)
  js, ts = jstate.State(*args), tstate.State(*args)
  js.set(host)
  ts.set(d)
  for want, got in zip(js.copy_to(), ts.copy_to()):
    np.testing.assert_array_equal(got, want)
  assert ts.time == js.time and np.array_equal(ts.state, js.state)
