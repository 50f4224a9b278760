"""Host syncs a loop step: the program's `sync.*` spans (each brackets one
read of a device value on the host) in the traced window over its loop
steps (lib/program_spans.py)."""

from benchmark.lib import program_spans


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None:
    return None
  syncs = sum(count for name, count in spans.counts.items()
              if program_spans.layer_of(name) == program_spans.SYNC)
  return syncs / spans.steps
