"""The evaluator's accounting of the first call of the window: each
episode's actions and whether it reached its goal, replayed by the
reference (benchmark/reference/transition.py `episode_actions`) from the
step types, discounts and seconds the program's env steps returned, and
held against the results the call returned. These are what
`env_steps_per_s` sums.

The evaluator ends an episode once its simulated seconds plus the wall
clock, read at the start of each chunk of steps, pass the timeout. The
benchmark reads the host's clock around each env step, so it knows each
chunk's reading to within the gap between two steps: the replay runs
with the earliest and the latest reading each chunk can have had, and an
episode passes when its count lies between the two.

Number: `episodes_off`, the episodes whose actions or goal lie outside
what the replay allows; an exact count. The control accumulates the
seconds in the precision one below float32 (bfloat16)."""

from __future__ import annotations

import torch

from benchmark.reference import precision as precision_lib
from benchmark.reference import transition


def _walls(record, chunk: int) -> tuple[list, list]:
  """The earliest and latest wall clock each chunk can have read."""
  times = [(s[3], s[4]) for s in record['steps']]
  first_entry, reset_exit = times[0][0], record['reset_exit']
  lo, hi = [0.0], [first_entry - reset_exit]
  for start in range(chunk, len(times), chunk):
    lo.append(times[start - 1][1] - first_entry)
    hi.append(times[start][0] - reset_exit)
  return lo, hi


def compare(samples, config, traffic, control: bool) -> dict:
  records = [s['episodes'] for s in samples if 'episodes' in s]
  if not records or not records[0]['steps'] or 'results' not in records[0]:
    return {'episodes_off': float('inf')}
  record = records[0]
  replay = lambda walls, precision='float32': [  # noqa: E731
      t.cpu() for t in transition.episode_actions(
          record['reset_elapsed'], [s[:3] for s in record['steps']], walls,
          chunk_steps=int(traffic['chunk_steps']),
          timeout_seconds=float(traffic['timeout_seconds']),
          precision=precision)]
  lo, hi = _walls(record, int(traffic['chunk_steps']))
  most, reached_early = replay(lo)
  least, reached_late = replay(hi)
  if control:
    got_actions, got_reached = replay(
        [(a + b) / 2.0 for a, b in zip(lo, hi)],
        precision_lib.LOWER[config['precision']['accounting']])
  else:
    got_actions = torch.tensor([a for a, _ in record['results']])
    got_reached = torch.tensor([r for _, r in record['results']])
  if got_actions.shape != most.shape:
    return {'episodes_off': float(max(most.numel(), 1))}
  fine = ((got_actions >= least) & (got_actions <= most)
          & ((got_reached == reached_early) | (got_reached == reached_late)))
  return {'episodes_off': float((~fine).sum())}
