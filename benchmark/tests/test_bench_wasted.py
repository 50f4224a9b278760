"""eval_loop.wasted_step_share on hand-made evaluator results."""

from benchmark.lib import cells


def _read(ctx):
  return cells.load_module('metrics', 'eval_loop.wasted_step_share').read(ctx)


def test_wasted_share_counts_only_live_steps():
  from putting_dune_torch import eval_lib

  results = [eval_lib.EvalResult(seed=i, reached_goal=True,
                                 num_actions_taken=n,
                                 agent_seconds_to_goal=float('nan'),
                                 environment_seconds_to_goal=1.0,
                                 total_reward=1.0)
             for i, n in enumerate((10, 40, 25, 5))]
  # One call of batch 4 ran 40 loop steps (its longest episode): 160
  # slots, 80 of them live.
  counters = {'policy_calls': 40,
              'live_steps': sum(r.num_actions_taken for r in results)}
  assert _read({'batch': 4, 'counters': counters}) == 0.5


def test_wasted_share_is_silent_without_steps():
  assert _read({'batch': 4, 'counters': {'policy_calls': 0,
                                         'live_steps': 0}}) is None
