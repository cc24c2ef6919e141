"""The port's native policy host (runtime/) and AgentRunner.

The host is the port's own copy of the lock-free double-buffered spline
(built with g++ into build/ at first use): its samples against the JAX
package's `spline.sample` (to 1e-6; nodes, times and the grid are exact in
float32, so the float64 host and JAX's float32 differ by rounding only),
the ctrl-range clamp, concurrent publish and sample without torn reads,
and the runner's background planning on Cartpole on the CPU (the lane
planner's plain version, K=8, H=20) with an exact read-back of a published
policy.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch.agent.runner import AgentRunner
from mujoco_mpc_tpu_torch.ops import sampling_lane
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.planners import ilqg as tilqg
from mujoco_mpc_tpu_torch.planners import sampling as tsampling
from mujoco_mpc_tpu_torch.runtime.runtime import PolicyRuntime
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import tt


@pytest.mark.parametrize("interp", [0, 1, 2])
def test_native_spline_matches_jax(interp):
  import jax.numpy as jnp

  from mujoco_mpc_tpu import spline as jspline
  rng = np.random.default_rng(0)
  nu, nn = 3, 8
  values = rng.standard_normal((nn, nu)).astype(np.float32)
  t0, dt = 0.5, 0.125

  rt = PolicyRuntime(nu, nn, interp=interp)
  rt.update(t0, dt, values)
  pol = jspline.SplinePolicy(t0=jnp.float32(t0), dt=jnp.float32(dt),
                             values=jnp.asarray(values), interp=interp)
  for t in np.arange(-0.25, 2.0, 1 / 32):
    want = np.asarray(jspline.sample(pol, jnp.float32(t)))
    np.testing.assert_allclose(rt.action(t), want, atol=1e-6,
                               err_msg=f"t={t}")


def test_ctrlrange_clamp():
  rt = PolicyRuntime(2, 4, interp=1, ctrl_lo=[-0.5, -1.0],
                     ctrl_hi=[0.5, 1.0])
  rt.update(0.0, 0.1, np.array([[2.0, -3.0]] * 4))
  np.testing.assert_allclose(rt.action(0.15), [0.5, -1.0])
  with pytest.raises(ValueError, match="expected"):
    rt.update(0.0, 0.1, np.zeros((3, 2)))


def test_concurrent_publish_and_sample():
  nu, nn = 4, 6
  rt = PolicyRuntime(nu, nn, interp=1)
  stop = threading.Event()
  errors = []

  def writer():
    i = 0
    while not stop.is_set():
      rt.update(0.0, 0.1, np.full((nn, nu), float(i % 7)))
      i += 1

  def reader():
    while not stop.is_set():
      a = rt.action(0.25)
      # every sample comes from one consistent slot: all components equal
      if not np.all(a == a[0]):
        errors.append(a.copy())

  threads = [threading.Thread(target=writer)] + \
      [threading.Thread(target=reader) for _ in range(2)]
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    for t in threads:
      t.start()
    time.sleep(1.0)
  finally:
    stop.set()
    for t in threads:
      t.join(timeout=10.0)
    sys.setswitchinterval(interval)
  assert not any(t.is_alive() for t in threads)
  assert not errors, f"torn reads: {errors[:3]}"
  assert rt.version > 10


def test_agent_runner_plans_in_the_background():
  """The plan thread re-optimizes while the control thread samples the
  native host and sets the state; a published constant policy reads back
  exactly."""
  pt = tregistry.get_task("Cartpole", device="cpu")
  cfg = dataclasses.replace(tsampling.make_config(pt), num_trajectory=8,
                            horizon=20)
  planner = sampling_lane.LaneSamplingPlanner(pt, cfg, device="cpu")
  runner = AgentRunner(pt, planner=planner)
  pol = planner.policy.replace(
      values=torch.full_like(planner.policy.values, 0.25))
  runner._publish(pol)
  np.testing.assert_array_equal(runner.action(0.0), [0.25])

  v0 = runner.policy_version
  d = pt.make_data()
  with runner:
    deadline = time.time() + 120.0
    steps = 0
    while (runner.iterations < 3 or steps < 20) and time.time() < deadline:
      u = runner.action(float(d.time))
      assert u.shape == (pt.model.nu,) and np.all(np.isfinite(u))
      d = TF.step(pt.model, d.replace(ctrl=tt(u)))
      runner.set_state(qpos=d.qpos.numpy(), qvel=d.qvel.numpy(),
                       time=float(d.time))
      steps += 1
  assert runner.iterations >= 3, runner.iterations
  assert runner.policy_version >= v0 + runner.iterations
  # what set_state stored becomes the planner's start state
  d0 = runner._snapshot()
  np.testing.assert_array_equal(d0.qpos.numpy(), d.qpos.numpy())
  np.testing.assert_array_equal(d0.qvel.numpy(), d.qvel.numpy())
  assert float(d0.time) == float(d.time)


def test_agent_runner_refuses_a_policy_that_is_not_a_spline():
  pt = tregistry.get_task("Swimmer", device="cpu")
  planner = tilqg.ILQGPlanner(
      pt, tilqg.make_config(pt).replace(horizon=5), device="cpu")
  with pytest.raises(NotImplementedError, match="ILQGPlanner.*not a spline"):
    AgentRunner(pt, planner=planner)
