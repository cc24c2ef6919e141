"""Planner names and construction by name.

The names and their order are the reference GUI's (mjpc/planners/
include.cc), as in the JAX package's planners/base.py; `agent_planner` in a
task's numerics is an index into PLANNER_NAMES. Each name builds its own
planner with that planner's default routes (on a CUDA device its kernels,
or NotImplementedError naming the gate); nothing falls back to another
planner.
"""

from __future__ import annotations

PLANNER_NAMES = ["Sampling", "Gradient", "iLQG", "iLQS", "Robust Sampling",
                 "Cross Entropy", "Sample Gradient"]


def is_ranked(planner) -> bool:
  """True if the planner publishes per-candidate scores via
  info['returns'] (the reference's RankedPlanner contract)."""
  info = getattr(planner, "last_info", None)
  if info is not None and "returns" in info:
    return True
  return getattr(planner, "ranked", False)


def make_planner(task, name: str, device="cuda"):
  """Construct the named planner for `task` on `device`. Accepts the GUI
  names and the aliases "Predictive Sampling" and "Sampling Lane" (the lane
  planner, ops/sampling_lane.py)."""
  if name in ("Sampling Lane", "Predictive Sampling Lane"):
    from mujoco_mpc_tpu_torch.ops import sampling_lane
    return sampling_lane.LaneSamplingPlanner(task, device=device)
  if name in ("Sampling", "Predictive Sampling"):
    from mujoco_mpc_tpu_torch.planners import sampling
    return sampling.SamplingPlanner(task, device=device)
  if name == "Cross Entropy":
    from mujoco_mpc_tpu_torch.planners import cross_entropy
    return cross_entropy.CrossEntropyPlanner(task, device=device)
  if name == "Gradient":
    from mujoco_mpc_tpu_torch.planners import gradient
    return gradient.GradientPlanner(task, device=device)
  if name == "iLQG":
    from mujoco_mpc_tpu_torch.planners import ilqg
    return ilqg.ILQGPlanner(task, device=device)
  if name == "iLQS":
    from mujoco_mpc_tpu_torch.planners import ilqs
    return ilqs.ILQSPlanner(task, device=device)
  if name == "Robust Sampling":
    from mujoco_mpc_tpu_torch.planners import robust
    return robust.RobustPlanner(task, device=device)
  if name == "Sample Gradient":
    from mujoco_mpc_tpu_torch.planners import sample_gradient
    return sample_gradient.SampleGradientPlanner(task, device=device)
  raise ValueError(
      f"unknown planner {name!r}; available: {PLANNER_NAMES}")
