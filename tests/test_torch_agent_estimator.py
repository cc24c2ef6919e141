"""The Agent with a filter in the loop (agent/agent.py): "Kalman",
"Unscented" and "Batch" build on the CPU when asked; `step_env` feeds the
filter the sensor reading after each step plus the agent's noise, and
`plan_data` is the filter's state. The closed EKF loop of
tests/test_agent_estimator.py (planner "Sampling", sensor noise 0.01,
two plans every 4 steps over 500 steps there) shortened to 40 steps with
one plan every 4, the lane planner's plain version planning (the pipeline
planner takes ~17 s a plan on the CPU): the estimation error's mean over
the last 10 steps below the JAX test's 0.3.
"""

import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch.agent import agent as tagent
from mujoco_mpc_tpu_torch.estimators.batch import Batch
from mujoco_mpc_tpu_torch.estimators.kalman import Kalman
from mujoco_mpc_tpu_torch.estimators.unscented import Unscented
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import to_np

LOOP_STEPS, PLAN_EVERY, TAIL = 40, 4, 10


@pytest.mark.parametrize("name,cls", [("Kalman", Kalman),
                                      ("Unscented", Unscented),
                                      ("Batch", Batch)])
def test_filters_build_and_feed(name, cls):
  """Each filter builds on the CPU, one step_env feeds it, and the
  planner's Data carries the filter's state, not the simulation's."""
  pt = tregistry.get_task("Cartpole", device="cpu")
  agent = tagent.Agent(pt, planner="Sampling Lane", estimator=name,
                       sensor_noise=0.01, device="cpu")
  assert isinstance(agent.estimator, cls)
  assert agent.estimator.device == torch.device("cpu")
  before = agent.estimator.state.copy()
  agent.step_env()
  after = agent.estimator.state
  assert np.isfinite(after).all() and not np.array_equal(after, before)
  d = agent.plan_data()
  nq, nv = pt.model.nq, pt.model.nv
  np.testing.assert_allclose(to_np(d.qpos), after[:nq], atol=1e-6)
  np.testing.assert_allclose(to_np(d.qvel), after[nq:nq + nv], atol=1e-6)
  assert not np.array_equal(to_np(d.qpos), to_np(agent.data.qpos))
  agent.reset()
  np.testing.assert_allclose(agent.estimator.state, before, atol=1e-6)


def test_ground_truth_plans_from_the_simulation_and_names_are_checked():
  pt = tregistry.get_task("Cartpole", device="cpu")
  agent = tagent.Agent(pt, planner="Sampling Lane",
                       estimator="Ground Truth", device="cpu")
  assert agent.estimator is None and agent.plan_data() is agent.data
  agent.set_estimator("Unscented")
  assert isinstance(agent.estimator, Unscented)
  with pytest.raises(ValueError, match="unknown estimator"):
    agent.set_estimator("Oracle")


def test_closed_ekf_loop_tracks_on_the_cpu():
  pt = tregistry.get_task("Cartpole", device="cpu")
  agent = tagent.Agent(pt, planner="Sampling Lane", seed=1,
                       estimator="Kalman", sensor_noise=0.01, device="cpu")
  errs, planned = [], []
  for t in range(LOOP_STEPS):
    if t % PLAN_EVERY == 0:
      agent.plan_iteration()
      planned.append(to_np(agent.plan_data().qpos))
    agent.step_env()
    true_x = np.concatenate([to_np(agent.data.qpos), to_np(agent.data.qvel)])
    errs.append(np.linalg.norm(agent.estimator.state[:4] - true_x))
  assert np.isfinite(errs).all()
  assert np.mean(errs[-TAIL:]) < 0.3, errs
  # the loop moved the pole: the plans saw a moving estimate
  assert np.abs(planned[-1] - planned[0]).max() > 1e-3
