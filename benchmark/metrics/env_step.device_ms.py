"""Device milliseconds of the kernels launched inside the `bench.env_step`
span (simulator, KMC, render), per env step of the traced part."""

from benchmark.lib import trace as trace_lib


def read(ctx):
  trace = ctx.get('trace')
  if trace is None:
    return None
  steps = trace_lib.span_count(trace, 'bench.env_step')
  if not steps:
    return None
  return trace_lib.device_seconds_by_span(trace).get(
      'bench.env_step', 0.0) / steps * 1e3
