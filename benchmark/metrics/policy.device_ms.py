"""Device milliseconds of the kernels launched inside the `bench.policy`
span, per loop step of the traced part."""

from benchmark.lib import trace as trace_lib


def read(ctx):
  trace = ctx.get('trace')
  if trace is None:
    return None
  steps = trace_lib.span_count(trace, 'bench.policy')
  if not steps:
    return None
  return trace_lib.device_seconds_by_span(trace).get(
      'bench.policy', 0.0) / steps * 1e3
