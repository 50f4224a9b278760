"""Share of the evaluator's env slots spent on episodes already over:
1 - (sum of num_actions over the window's episodes) / (batch x loop
steps), the loop steps counted by the benchmark's policy wrapper."""


def read(ctx):
  counters = ctx['counters']
  slots = ctx['batch'] * counters['policy_calls']
  if not slots:
    return None
  return 1.0 - counters['live_steps'] / slots
