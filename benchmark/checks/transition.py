"""The env step's transition at each recorded loop step: the reference
(benchmark/reference/transition.py) replays the step from the state it
started from, the action the policy took and the uniforms the KMC drew,
and is held against what the program's step produced.

Numbers: `beam_gap`, the largest distance in angstroms between the beam
the program's KMC was handed and the reference's, over every row;
`transition_rows_off`, the share of rows not reset by the step whose
silicon site, field of view (by more than 1e-4 angstroms), seconds (by
more than 1e-4 s), step type or reward (by more than 1e-6) differ from
the reference's, or whose KMC drew for more or fewer rounds than the
dwell needs."""

from __future__ import annotations

import torch

from benchmark.reference import precision as precision_lib
from benchmark.reference import rates
from benchmark.reference import transition

LAWS = {'simple_canonical_rates': rates.simple_canonical}
POSITION_TOL = 1e-4
SECONDS_TOL = 1e-4
REWARD_TOL = 1e-6


def _program(sample) -> dict:
  scene, ts = sample['scene'], sample['transition']['timestep']
  calls = sample['rate_calls']
  return {'beam': calls[0][1] if calls else None,
          'si_index': scene['si_index'], 'lower_left': scene['lower_left'],
          'upper_right': scene['upper_right'],
          'elapsed_seconds': ts['elapsed_seconds'],
          'step_type': ts['step_type'], 'reward': ts['reward'],
          'rounds_off': torch.zeros_like(ts['reward'], dtype=torch.bool)}


def _off(got: dict, ref: dict, keep: torch.Tensor) -> tuple[int, int]:
  near = lambda k, tol: (torch.abs(got[k] - ref[k]) <= tol)  # noqa: E731
  fine = ((got['si_index'].to(torch.int64) == ref['si_index'])
          & near('lower_left', POSITION_TOL).all(-1)
          & near('upper_right', POSITION_TOL).all(-1)
          & near('elapsed_seconds', SECONDS_TOL)
          & (got['step_type'].to(torch.int64) == ref['step_type'])
          & near('reward', REWARD_TOL)
          & ~got['rounds_off'] & ~ref['rounds_off'])
  return int((keep & ~fine).sum()), int(keep.sum())


def compare(samples, config, traffic, control: bool) -> dict:
  env = config['env']
  law = LAWS[env['rate_fn']]
  beam_gap, off, rows, steps = 0.0, 0, 0, 0
  for sample in samples:
    if 'transition' not in sample:
      continue
    rec = sample['transition']
    replay = lambda p: transition.step(  # noqa: E731
        rec['before'], rec['action'], rec['kmc_uniforms'], law=law, env=env,
        precision=p)
    ref = replay('float32')
    got = (replay(precision_lib.LOWER[config['precision']['transition']])
           if control else _program(sample))
    if got['beam'] is None or got['beam'].shape != ref['beam'].shape:
      return {'beam_gap': float('inf'), 'transition_rows_off': 1.0}
    gap = torch.linalg.vector_norm(got['beam'] - ref['beam'], dim=-1)
    gap = torch.nan_to_num(gap, nan=float('inf'))
    beam_gap = max(beam_gap, float(gap.max()))
    n_off, n = _off(got, ref, ~rec['before']['needs_reset'])
    off, rows, steps = off + n_off, rows + n, steps + 1
  if not steps:
    return {'beam_gap': float('inf'), 'transition_rows_off': 1.0}
  return {'beam_gap': beam_gap,
          'transition_rows_off': off / max(rows, 1)}
