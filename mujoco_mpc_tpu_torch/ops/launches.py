"""Launch counts of the hand-written kernels.

Each kernel wrapper counts a launch where it launches its kernel, and
nowhere else. An eager launch adds one to its module's `launch_count` on
the host. A launch made while a CUDA graph is being captured runs only
when the graph is replayed, so it adds nothing on the host: instead the
capture records, right after the kernel, an add of one to the module's
tally on the device (`replay_counts[device index]`), and every replay of
the graph makes that add beside the kernel. The launches of a run are
`launch_count` plus `replays(replay_counts)`.
"""

from __future__ import annotations

import torch


def count(replay_counts: dict, device: torch.device) -> int:
  """One launch just made on `device`: returns 1 for the wrapper to add to
  its `launch_count` where the launch is eager; under a graph capture
  returns 0 and records the device tally's add into the graph. The tally
  is made at the device's first eager launch (made during a capture, its
  zero fill would be replayed too), so a capture on a device where the
  kernel has never launched eagerly raises."""
  index = torch.cuda.current_device() if device.index is None \
      else device.index
  if torch.cuda.is_current_stream_capturing():
    tally = replay_counts.get(index)
    if tally is None:
      raise RuntimeError(
          f"kernel captured into a CUDA graph before its first eager launch "
          f"on cuda:{index}: run the captured function once before the "
          "capture")
    tally.add_(1)
    return 0
  if index not in replay_counts:
    replay_counts[index] = torch.zeros((), dtype=torch.int64, device=device)
  return 1


def replays(replay_counts: dict) -> int:
  """The launches made by graph replays since the tallies were last zeroed
  (reads them back from the device)."""
  return sum(int(t) for t in replay_counts.values())


def zero(replay_counts: dict) -> None:
  for t in replay_counts.values():
    t.zero_()
