"""Milliseconds a loop step in which the device ran nothing while the host
was in no program span: Python between the program's calls, and the
benchmark's proxies, inside their `bench.*` spans or under a bare
`eval_loop.step`, outside the program's spans there. The six `*.idle_ms`
parts sum to the window's idle time (lib/program_spans.py)."""

from benchmark.lib import program_spans


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None:
    return None
  return program_spans.per_step_ms(spans.idle_s['outside_program'], spans)
