"""KMC event rounds a loop step: the program's `kmc.round` spans in the
traced window over its loop steps (lib/program_spans.py)."""

from benchmark.lib import program_spans


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None:
    return None
  return spans.counts.get('kmc.round', 0) / spans.steps
