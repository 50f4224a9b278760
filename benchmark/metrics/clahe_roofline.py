"""The 512^2 CLAHE pair's share of its roofline, %: clahe_hist_lut's and
clahe_remap's summed least times at the cell's render shape over their
summed device time."""

from benchmark.lib import peaks
from benchmark.lib import trace as trace_lib


def read(ctx):
  trace = ctx.get('trace')
  if trace is None:
    return None
  hist_s, hists = trace_lib.kernel_seconds(trace, ('clahe_hist_lut_kernel',))
  remap_s, remaps = trace_lib.kernel_seconds(trace, ('clahe_remap_kernel',))
  if not hists or not remaps or hist_s + remap_s <= 0.0:
    return None
  shape = ctx['render_shape']
  bound = (hists * peaks.clahe_hist_lut_bound_s(*shape)
           + remaps * peaks.clahe_remap_bound_s(*shape))
  return 100.0 * bound / (hist_s + remap_s)
