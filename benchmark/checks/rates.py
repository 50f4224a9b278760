"""The KMC's transition rates: every rate call of each recorded env step
(a reset makes none), recomputed by the reference from the neighbour and
beam positions the step handed it.

Number: `rate_rel_gap`, the largest relative gap |program - reference| /
reference over all of them (the rates lie in (0, 1])."""

from __future__ import annotations

import torch

from benchmark.reference import precision as precision_lib
from benchmark.reference import rates

LAWS = {'simple_canonical_rates': rates.simple_canonical}


def compare(samples, config, traffic, control: bool) -> dict:
  law = LAWS[config['env']['rate_fn']]
  lower = precision_lib.LOWER[config['precision']['rates']]
  worst, calls = 0.0, 0
  for sample in samples:
    for nbr, beam, got in sample.get('rate_calls', ()):
      ref = law(nbr, beam)
      if control:
        got = law(nbr, beam, lower)
      gap = torch.abs(got - ref) / torch.clamp(ref, min=1e-30)
      gap = torch.where(torch.isfinite(got), gap, torch.full_like(gap, 1e30))
      worst = max(worst, float(gap.max()))
      calls += 1
  if not calls:
    return {'rate_rel_gap': float('inf')}
  return {'rate_rel_gap': worst}
