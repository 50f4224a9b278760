"""Milliseconds a loop step in which the device ran nothing while the host
was in the policy's spans (`policy.*`); a `sync.*` span's part goes to its
parent's layer. The six `*.idle_ms` parts sum to the window's idle time
(lib/program_spans.py)."""

from benchmark.lib import program_spans


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None:
    return None
  return program_spans.per_step_ms(spans.idle_s['policy'], spans)
