"""Share of the traced window in which no kernel, copy or memset ran on
the device (the union of their intervals)."""

from benchmark.lib import trace as trace_lib


def read(ctx):
  trace = ctx.get('trace')
  if trace is None:
    return None
  window = trace_lib.window_seconds(trace)
  if window <= 0.0:
    return None
  return 1.0 - trace_lib.busy_seconds(trace) / window
