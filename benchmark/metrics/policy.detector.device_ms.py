"""Device milliseconds of the kernels launched inside the program's
`policy.detector` spans (the UNet and its softmax), a loop step
(lib/program_spans.py)."""

from benchmark.lib import program_spans


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None:
    return None
  return program_spans.per_step_ms(
      spans.device_s.get('policy.detector', 0.0), spans)
