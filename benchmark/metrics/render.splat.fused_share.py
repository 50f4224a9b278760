"""Share of the program's clean-frame splats that ran as the fused
`splat_render` kernel: its launches in the traced window over the
`render.splat` spans that start in it (lib/program_spans.py). 0 where
every splat took the batched matrix product."""

from benchmark.lib import program_spans
from benchmark.lib import trace as trace_lib


def read(ctx):
  spans = program_spans.read(ctx)
  if spans is None or not spans.counts.get('render.splat'):
    return None
  _, launches = trace_lib.kernel_seconds(ctx['trace'],
                                         ('splat_render_kernel',))
  return launches / spans.counts['render.splat']
