"""The program's spans (utils/profiling.span): on the profiler's timeline
only while a profiler records, nested layer in layer, one `kmc.round` a
KMC round, and no change to any result."""

import contextlib

import pytest
import torch

from putting_dune_torch import eval as eval_cli
from putting_dune_torch import eval_lib
from putting_dune_torch import registry
from putting_dune_torch import run_helpers
from putting_dune_torch.utils import profiling

SEEDS = [0, 1]

# Each span's nearest enclosing program span, by name prefix; the pixel
# policy's and the vision planner's spans in one table.
PARENTS = {
    'eval_loop.step': None,
    'eval_loop.setup': None,
    'policy.step': 'eval_loop.step',
    'policy.actor_critic': 'policy.step',
    'policy.detector': 'policy.step',
    'policy.lattice_frame': 'policy.step',
    'policy.planner': 'policy.step',
    'policy.rates': 'policy.planner',
    'sync.planner_candidates': 'policy.planner',
    'sync.planner_angles': 'policy.planner',
    'env_step.adapter': 'env_step.step',
    'env_step.goal': 'env_step.step',
    'env_step.auto_reset': 'env_step.step',
    'env_step.features': 'env_step.step',
    'sync.reset_count': 'env_step.auto_reset',
    'kmc.apply_control': 'env_step.step',
    'kmc.round': 'kmc.apply_control',
    'sync.kmc_active': 'kmc.apply_control',
    'render.splat': 'env_step.step',
    'render.noise': 'env_step.step',
    'render.clahe': 'env_step.step',
    'render.resize': 'env_step.features',
    'sync.noise_jitter': 'render.noise',
    'sync.eval_done_all': 'eval_loop.accounting',
    'sync.eval_results': 'eval_loop.accounting',
}

CELLS = {
    'ppo_simple_images_tf': (
        'policy.actor_critic',),
    'vision_planner_simple_rates': (
        'policy.detector', 'policy.lattice_frame', 'policy.planner',
        'policy.rates', 'sync.planner_candidates', 'sync.planner_angles'),
}
COMMON = (
    'eval_loop.setup', 'eval_loop.step', 'eval_loop.accounting',
    'policy.step', 'env_step.step', 'env_step.adapter', 'env_step.goal',
    'env_step.auto_reset', 'env_step.features', 'kmc.apply_control',
    'kmc.round', 'render.atom_window', 'render.splat', 'render.noise',
    'render.clahe', 'render.resize', 'sync.kmc_active', 'sync.reset_count',
    'sync.noise_jitter', 'sync.eval_done_all', 'sync.eval_results')


@pytest.fixture(scope='module', params=sorted(CELLS))
def cell(request):
  """(name, env, policy) at batch 2 and the 512^2 render on the CPU."""
  name = request.param
  experiment = registry.create_eval_experiment(name)
  policy = eval_cli.policy_for_agent(experiment.get_policy(
      experiment.get_adapters_and_goal(), 'cpu'))
  env = run_helpers.create_batched_env(
      experiment.get_adapters_and_goal, experiment.get_simulator_config,
      batch_size=len(SEEDS), image_size=512, device='cpu')
  return name, env, policy


def _evaluate(env, policy):
  return eval_lib.evaluate_batched(env, policy, SEEDS, max_steps=2)


def _profiled(env, policy):
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    results = _evaluate(env, policy)
  return results, prof.events()


def _program_parent(event):
  parent = event.cpu_parent
  while parent is not None and parent.name.split('.')[0] not in (
      'eval_loop', 'policy', 'env_step', 'kmc', 'render', 'sync'):
    parent = parent.cpu_parent
  return None if parent is None else parent.name


def test_span_is_one_shared_null_context_without_a_profiler():
  assert not torch.autograd._profiler_enabled()  # pylint: disable=protected-access
  first, second = profiling.span('kmc.round'), profiling.span('render.splat')
  assert first is second
  assert isinstance(first, contextlib.nullcontext)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    assert isinstance(profiling.span('kmc.round'),
                      torch.profiler.record_function)


def test_no_span_is_opened_without_a_profiler(cell, monkeypatch):
  _, env, policy = cell

  def refuse(name, *args, **kwargs):
    raise AssertionError(f'span {name!r} opened with no profiler on')

  monkeypatch.setattr(torch.profiler, 'record_function', refuse)
  assert len(_evaluate(env, policy)) == len(SEEDS)


def test_every_span_is_there_and_nested_in_its_layer(cell):
  name, env, policy = cell
  _, events = _profiled(env, policy)
  names = {e.name for e in events}
  missing = set(COMMON + CELLS[name]) - names
  assert not missing
  for event in events:
    if event.name in PARENTS:
      assert _program_parent(event) == PARENTS[event.name], event.name
  accounting = [_program_parent(e) for e in events
                if e.name == 'eval_loop.accounting']
  assert 'eval_loop.step' in accounting
  windows = [_program_parent(e) for e in events
             if e.name == 'render.atom_window']
  assert set(windows) <= {'env_step.step'}


def test_one_kmc_round_span_per_rate_call(cell):
  _, env, policy = cell
  rate_fn = env.rate_fn
  calls = []

  def counting_rate_fn(*args):
    calls.append(1)
    return rate_fn(*args)

  env.rate_fn = counting_rate_fn
  try:
    _, events = _profiled(env, policy)
  finally:
    env.rate_fn = rate_fn
  count = lambda name: sum(1 for e in events if e.name == name)  # noqa: E731
  assert count('kmc.round') == len(calls) > 0
  # A call reads `active.any()` once more than it runs rounds.
  assert count('sync.kmc_active') == (count('kmc.round')
                                      + count('kmc.apply_control'))


def test_tracing_changes_no_result(cell):
  _, env, policy = cell
  plain = _evaluate(env, policy)
  traced, _ = _profiled(env, policy)
  # repr: NaN seconds of episodes that did not reach the goal compare
  # unequal as floats.
  assert repr(traced) == repr(plain)
