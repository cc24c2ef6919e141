"""Replay a tier-1 test run's schedule under pytest-xdist `--dist load`.

Reads the per-test times of a finished run (its `--junitxml` file) and the
collection order (`pytest --collect-only -q` with the run's options), then
replays xdist's load scheduling (xdist 3.x `LoadScheduling`: each worker
first takes a consecutive chunk of (N // workers) // 4 tests, then, when
its queue runs low and its last test was short, a further consecutive
slice of the pending tests). Prints each worker's first chunk (files and
seconds) and when each worker would finish, so a run's makespan can be
traced to the tests that set it, then each file's serial seconds and the
share of the port's tests (`tests/test_torch_*`).

  python -m pytest tests/ -q -m 'not slow' --collect-only -p no:randomly \\
      | grep '::' > collect.txt
  python3 scripts/tier1_schedule.py run.xml collect.txt [--workers 6]

Times are the run's own (test setup and call), so the replay inherits the
load of the machine that ran it.
"""

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def test_times(junit_path):
  times = {}
  for case in ET.parse(junit_path).getroot().iter("testcase"):
    path = case.get("classname").replace(".", "/") + ".py::" + case.get(
        "name")
    times[path] = float(case.get("time", 0.0))
  return times


def replay(durations, workers):
  """Finish time of each worker under xdist's load scheduling."""
  n = len(durations)
  chunk = max((n // workers) // 4, 2)
  queues = [list(range(w * chunk, min((w + 1) * chunk, n)))
            for w in range(workers)]
  pending = list(range(min(workers * chunk, n), n))
  events = [(durations[q[0]], w) for w, q in enumerate(queues) if q]
  heapq.heapify(events)
  finish = [0.0] * workers
  while events:
    now, w = heapq.heappop(events)
    last = durations[queues[w].pop(0)]
    queue = queues[w]
    if pending:
      low = max(2, len(pending) // workers // 4)
      high = max(2, len(pending) // workers // 2)
      if len(queue) < low and not (last >= 0.1 and len(queue) >= 2):
        take = high - len(queue)
        queue += pending[:take]
        del pending[:take]
    if queue:
      heapq.heappush(events, (now + durations[queue[0]], w))
    else:
      finish[w] = now
  return chunk, finish


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("junit")
  parser.add_argument("collected")
  parser.add_argument("--workers", type=int, default=6)
  args = parser.parse_args()
  times = test_times(args.junit)
  order = [line.strip() for line in open(args.collected) if "::" in line]
  missing = [t for t in order if t not in times]
  durations = [times.get(t, 0.0) for t in order]
  chunk, finish = replay(durations, args.workers)
  print(f"tests {len(order)} (without a time: {len(missing)}), serial "
        f"{sum(durations):.0f} s, first chunk {chunk} tests a worker")
  for w in range(args.workers):
    lo, hi = w * chunk, min((w + 1) * chunk, len(order)) - 1
    print(f"worker {w}: first chunk [{lo}, {hi}] "
          f"{order[lo].split('::')[0]} .. {order[hi].split('::')[0]}: "
          f"{sum(durations[lo:hi + 1]):.0f} s; finishes at {finish[w]:.0f} s")
  by_file = collections.Counter()
  for test, seconds in zip(order, durations):
    by_file[test.split("::")[0]] += seconds
  port = sum(v for k, v in by_file.items()
             if k.startswith("tests/test_torch_"))
  print(f"the port's tests (tests/test_torch_*): {port:.1f} s of "
        f"{sum(durations):.1f} s serial")
  for name, seconds in by_file.most_common():
    print(f"{seconds:8.1f} s  {name}")


if __name__ == "__main__":
  main()
