"""The port's eval CLI parses the JAX package's command lines as it does.

The same argv lists go through both packages' `_parse_args` (the JAX one
reads sys.argv, so it is monkeypatched), and every parsed field both
packages have must agree.
"""

import dataclasses
import os
import sys
import types

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
  # Both evaluators now write {seed}.gif; what still raises is a video
  # asked of a mesh-sharded evaluation, with the JAX package's message.
  batched = t_eval.main(t_eval.Args(
      experiment_name='greedy_simple_rates', device='cpu',
      video_save_dir=str(tmp_path / 'batched')))
  assert sorted(os.listdir(tmp_path / 'batched')) == [
      f'{s}.gif' for s in range(4)]
  host = t_eval.main(t_eval.Args(
      experiment_name='greedy_simple_rates', batched=False, device='cpu',
      video_save_dir=str(tmp_path / 'host')))
  assert sorted(os.listdir(tmp_path / 'host')) == sorted(
      f'{r.seed}.gif' for r in host['results'])
  assert batched['aggregate']['average_num_times_reached_goal'] == 1.0
  mesh = types.SimpleNamespace(shape={'data': 1}, rank=0)
  with pytest.raises(ValueError, match='video'):
    t_eval_lib.evaluate_batched(None, None, [], video_save_dir='v',
                                mesh=mesh)


# --- the pipeline CLIs -------------------------------------------------------

from putting_dune_torch.pipeline import align_trajectories as t_align  # noqa: E402
from putting_dune_torch.pipeline import convert_riegeli as t_convert  # noqa: E402
from putting_dune_torch.pipeline import train_rate_learner as t_trl  # noqa: E402
from putting_dune_tpu.pipeline import align_trajectories as j_align  # noqa: E402
from putting_dune_tpu.pipeline import convert_riegeli as j_convert  # noqa: E402
from putting_dune_tpu.pipeline import train_rate_learner as j_trl  # noqa: E402

PATHS = ['--source_path=in.tfrecords', '--target_path=out.riegeli']
PIPELINE_ARGVS = {
    'align_trajectories': (t_align, j_align, [
        PATHS + ['--aligner_workdir=w'],
        PATHS + ['--aligner_workdir=w', '--history_length=3', '--hybrid',
                 '--relabel', '--alignment_iterations=2',
                 '--base_step_size=0.5'],
        PATHS + ['--aligner_workdir=w', '--no-hybrid', '--no-relabel'],
    ]),
    'train_rate_learner': (t_trl, j_trl, [
        ['--source_path=s', '--workdir=w'],
        ['--source_path=s', '--workdir=w', '--no-plot_metrics',
         '--no-visualize_rates', '--epochs=10', '--num_models=100',
         '--hidden_dimensions', '128', '128', '--batch_size=256'],
        ['--source_path=s', '--workdir=w', '--learner_type=knn',
         '--no-bootstrap', '--no-distill', '--val_frac=0.2', '--seed=3',
         '--hidden_dimensions', '16', '--previous_controls_at_current_timestep',
         '--neighbor_distance_cutoff=0.5', '--no-use_current'],
    ]),
    'convert_riegeli': (t_convert, j_convert, [PATHS]),
}


def _pipeline_cases():
  for name, (_, _, argvs) in PIPELINE_ARGVS.items():
    for i in range(len(argvs)):
      yield pytest.param(name, i, id=f'{name}-{i}')


@pytest.mark.parametrize('name,index', list(_pipeline_cases()))
def test_pipeline_clis_parse_the_jax_command_lines(monkeypatch, name, index):
  port, jax_module, argvs = PIPELINE_ARGVS[name]
  argv = argvs[index]
  monkeypatch.setattr(sys, 'argv', [name] + argv)
  want = dataclasses.asdict(jax_module._parse_args())
  got = dataclasses.asdict(port._parse_args(argv))
  assert set(want) <= set(got)
  assert {k: got[k] for k in want} == want
  assert set(got) - set(want) <= {'device'}


@pytest.mark.parametrize('missing', ['--source_path', '--target_path',
                                     '--aligner_workdir'])
def test_align_trajectories_requires_its_paths_as_jax_does(monkeypatch,
                                                           missing):
  argv = [a for a in PATHS + ['--aligner_workdir=w']
          if not a.startswith(missing)]
  monkeypatch.setattr(sys, 'argv', ['align'] + argv)
  with pytest.raises(SystemExit):
    j_align._parse_args()
  with pytest.raises(SystemExit):
    t_align._parse_args(argv)
  assert {f.name for f in dataclasses.fields(t_align.Args)
          if f.default is dataclasses.MISSING} == {
              'source_path', 'target_path', 'aligner_workdir'}


def test_train_rate_learner_absl_spellings():
  args = t_trl._parse_args(['--source_path=s', '--workdir=w',
                            '--noplot_metrics', '--novisualize_rates',
                            '--nodistill', '--device=cpu'])
  assert (args.plot_metrics, args.visualize_rates, args.distill) == (
      False, False, False)
  assert args.device == 'cpu' and args.hidden_dimensions == (128, 128)
