"""The port's eval CLI parses the JAX package's command lines as it does.

The same argv lists go through both packages' `_parse_args` (the JAX one
reads sys.argv, so it is monkeypatched), and every parsed field both
packages have must agree.
"""

import dataclasses
import sys

import pytest

from putting_dune_torch import eval as t_eval
from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_tpu import eval as j_eval

ARGVS = [
    ['--experiment_name=greedy_simple_rates'],
    ['--experiment_name=greedy_simple_rates', '--batched'],
    ['--experiment_name=greedy_simple_rates', '--no-batched'],
    ['--experiment_name=x', '--no-batched', '--seed=3',
     '--eval_suite=small_eval', '--step_limit=50'],
    ['--experiment_name=x', '--video_save_dir=/tmp/v'],
    ['--experiment_name=x', '--no-batched', '--video_save_dir=/tmp/v',
     '--output_json=out.json'],
    ['--experiment_name=x', '--mesh=data'],
    ['--experiment_name=x', '--no-batched', '--batched'],
]


def _jax_args(monkeypatch, argv):
  monkeypatch.setattr(sys, 'argv', ['eval'] + argv)
  return j_eval._parse_args()


@pytest.mark.parametrize('argv', ARGVS, ids=lambda a: ' '.join(a[1:]) or
                         'default')
def test_same_argv_same_fields(monkeypatch, argv):
  want = dataclasses.asdict(_jax_args(monkeypatch, argv))
  got = dataclasses.asdict(t_eval._parse_args(argv))
  shared = sorted(set(want) & set(got))
  assert {'batched', 'video_save_dir', 'seed', 'mesh'} <= set(shared)
  assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


def test_nobatched_stays_an_alias():
  args = t_eval._parse_args(['--experiment_name=x', '--nobatched'])
  assert args.batched is False


def test_video_save_dir_raises_in_both_evaluators(tmp_path):
  with pytest.raises(NotImplementedError, match='plotting_utils'):
    t_eval.main(t_eval.Args(experiment_name='greedy_simple_rates',
                            video_save_dir=str(tmp_path), device='cpu'))
  with pytest.raises(NotImplementedError, match='plotting_utils'):
    t_eval.main(t_eval.Args(experiment_name='greedy_simple_rates',
                            batched=False, video_save_dir=str(tmp_path),
                            device='cpu'))
  with pytest.raises(NotImplementedError, match='plotting_utils'):
    t_eval_lib.evaluate_batched(None, None, [], video_save_dir='v')
