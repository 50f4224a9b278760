"""The whole loop step's share of the configuration's peak, %: the
policy model's FLOPs per loop step (2 x multiply-adds of its convolutions
and dense layers at the cell's batch, lib/flops.py) over the window's
seconds per loop step x the peak."""


def read(ctx):
  steps = ctx['counters']['policy_calls']
  if not steps or ctx['window_s'] <= 0.0:
    return None
  return (100.0 * ctx['flops_per_step'] * steps
          / (ctx['window_s'] * ctx['peak_flops']))
