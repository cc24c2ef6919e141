"""The port's EKF and UKF track Cartpole from a wrong initial state: the
tracking tests of tests/test_estimators.py:37-60 on the port alone. A
100-step trajectory of the port's own simulation under a smooth control,
each sensor reading taken after the step on a full forward pass plus
0.01 N(0, 1) noise; the filter starts 0.3 N(0, 1) off in qpos (the same
draws from the same generator as the JAX test). Bars (the
JAX suite's): the final state error below 0.1 and below half the first.
"""

import numpy as np
import pytest

from mujoco_mpc_tpu_torch import rollout as TR
from mujoco_mpc_tpu_torch.estimators.kalman import Kalman
from mujoco_mpc_tpu_torch.estimators.unscented import Unscented
from mujoco_mpc_tpu_torch.physics import forward as TF
from mujoco_mpc_tpu_torch.physics import sensors as tsensors
from mujoco_mpc_tpu_torch.tasks import registry as tregistry
from tests.torch_port_helpers import once_a_session, to_np, tt

STEPS = 100


def _simulate(pt, n, rng, ctrl_scale=0.3):
  """True states, noisy sensor readings and controls (the JAX test's
  `_simulate`, on the port's physics)."""
  m = pt.model
  fn = tsensors.make_sensor_fn(m)
  d = pt.make_data()
  states, sensors, ctrls = [], [], []
  for t in range(n):
    u = ctrl_scale * np.sin(0.05 * t + np.arange(m.nu))
    d = TF.step(m, d.replace(ctrl=tt(u)))
    y = to_np(fn(m, TF.forward(m, d)))
    states.append(to_np(TR.pack_state(d)))
    sensors.append(y + 0.01 * rng.standard_normal(y.shape))
    ctrls.append(u)
  return dict(states=np.array(states), sensors=np.array(sensors),
              ctrls=np.array(ctrls))


@pytest.mark.parametrize("name", ["kalman", "unscented"])
def test_filter_tracks_cartpole(name, tmp_path_factory):
  pt = tregistry.get_task("Cartpole", device="cpu")
  sim = once_a_session(tmp_path_factory, "tracking_cartpole",
                       lambda: _simulate(pt, STEPS, np.random.default_rng(0)))
  states, sensors, ctrls = sim["states"], sim["sensors"], sim["ctrls"]
  # the generator as the simulation left it, as in the JAX test
  rng = np.random.default_rng(0)
  rng.standard_normal(sensors.size)
  est = Kalman(pt) if name == "kalman" else Unscented(pt)
  x0 = states[0].copy()
  x0[:pt.model.nq] += 0.3 * rng.standard_normal(pt.model.nq)
  est.set_state(x0)
  errs = []
  for t in range(1, len(states)):
    est.update(ctrls[t], sensors[t])
    errs.append(np.linalg.norm(est.state - states[t]))
  assert errs[-1] < 0.1, f"final err {errs[-1]}, first {errs[0]}"
  assert errs[-1] < 0.5 * errs[0]
