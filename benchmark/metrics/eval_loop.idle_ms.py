"""Milliseconds a loop step in which the device ran nothing while the host
was in the eval loop's own work (`eval_loop.setup`, `eval_loop.accounting`
and their syncs); a bare `eval_loop.step`, where the loop calls through
the benchmark's proxies, counts as outside the program. The six
`*.idle_ms` parts sum to the window's idle time (lib/program_spans.py)."""

from benchmark.lib import program_spans


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None:
    return None
  return program_spans.per_step_ms(spans.idle_s['eval_loop'], spans)
