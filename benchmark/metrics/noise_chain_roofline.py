"""noise_chain's share of its roofline, %: each launch's least time at the
cell's render shape (lib/peaks.py), over the launches' device time."""

from benchmark.lib import peaks
from benchmark.lib import trace as trace_lib


def read(ctx):
  trace = ctx.get('trace')
  if trace is None or ctx.get('small_lambda_share') is None:
    return None
  seconds, launches = trace_lib.kernel_seconds(trace, ('noise_chain_kernel',))
  if not launches or seconds <= 0.0:
    return None
  bound = peaks.noise_chain_bound_s(*ctx['render_shape'],
                                    ctx['small_lambda_share'])
  return 100.0 * launches * bound / seconds
