"""The port's checkpoint manager against orbax's CheckpointManager.

`utils/checkpoints.CheckpointManager` stands in for orbax (absent on the
card's machine). Fed the same metric sequences with max_to_keep=3 and
the trainers' best functions in orbax's 'max' mode (the detector's
accuracy, the aligners' -drift_error), it must keep exactly the steps
orbax keeps, and report the same latest and best steps.
"""

import json
import math
import os

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from putting_dune_torch.atom_detection import train as t_det_train
from putting_dune_torch.image_alignment import train as t_align_train
from putting_dune_torch.utils import checkpoints
from putting_dune_torch.utils import training

SEQUENCES = {
    'rising': [0.1, 0.2, 0.3, 0.4, 0.5],
    'falling': [0.5, 0.4, 0.3, 0.2, 0.1],
    'mixed_with_ties': [0.3, 0.9, 0.1, 0.5, 0.2, 0.8, 0.8, 0.0],
    'all_equal': [0.5, 0.5, 0.5, 0.5],
    'with_nan': [0.2, math.nan, 0.3, 0.1, 0.05],
}


# The metric each trainer's best_fn reads, and that best_fn.
BEST_FNS = {
    'accuracy': t_det_train.best_fn,
    'drift_error': t_align_train.best_fn,
}


def _orbax_steps(directory, values, metric='accuracy'):
  manager = ocp.CheckpointManager(
      directory, options=ocp.CheckpointManagerOptions(
          max_to_keep=3, best_fn=BEST_FNS[metric], best_mode='max'))
  for step, value in enumerate(values):
    manager.save(step, args=ocp.args.StandardSave({'x': np.full(2, step)}),
                 metrics={metric: value})
  manager.wait_until_finished()
  out = (manager.all_steps(), manager.latest_step(), manager.best_step())
  manager.close()
  return sorted(out[0]), out[1], out[2]


def _port_steps(directory, values, metric):
  manager = checkpoints.CheckpointManager(
      directory, max_to_keep=3, best_fn=BEST_FNS[metric])
  for step, value in enumerate(values):
    manager.save(step, {'x': torch.full((2,), float(step))},
                 metrics={metric: value})
  return manager.all_steps(), manager.latest_step(), manager.best_step()


@pytest.mark.parametrize('metric', sorted(BEST_FNS))
@pytest.mark.parametrize('name', sorted(SEQUENCES))
def test_keeps_the_steps_orbax_keeps(tmp_path, name, metric):
  values = SEQUENCES[name]
  want = _orbax_steps(str(tmp_path / 'orbax'), values, metric)
  got = _port_steps(str(tmp_path / 'port'), values, metric)
  assert got == want
  # What is on disk is what the manager reports, and a fresh manager over
  # the folder reads the same steps back.
  kept = sorted(int(n) for n in os.listdir(tmp_path / 'port') if n.isdigit())
  assert kept == got[0]
  again = checkpoints.CheckpointManager(
      str(tmp_path / 'port'), max_to_keep=3, best_fn=BEST_FNS[metric])
  assert (again.all_steps(), again.latest_step(), again.best_step()) == want


def test_save_is_atomic_and_restores_tensors(tmp_path):
  manager = checkpoints.CheckpointManager(
      str(tmp_path), max_to_keep=2, best_fn=lambda m: -m['loss'])
  manager.save(0, {'w': torch.arange(3.0), 'step': 0}, {'loss': 1.0})
  manager.save(1, {'w': torch.arange(3.0) * 2, 'step': 1}, {'loss': 0.5})
  manager.save(2, {'w': torch.arange(3.0) * 3, 'step': 2}, {'loss': 0.2})
  # The two best steps stay; no temporary folder is left behind.
  assert sorted(os.listdir(tmp_path)) == ['1', '2']
  state = manager.restore(2)
  assert state['step'] == 2 and torch.equal(state['w'], torch.arange(3.0) * 3)
  with open(tmp_path / '2' / 'metrics.json') as f:
    assert json.load(f) == {'step': 2, 'metrics': {'loss': 0.2}}
  with pytest.raises(FileNotFoundError):
    manager.restore(0)


def test_refuses_orbax_folders_naming_params_msgpack(tmp_path):
  _orbax_steps(str(tmp_path / 'checkpoints'), [0.1, 0.2])
  with pytest.raises(ValueError, match='params.msgpack'):
    checkpoints.CheckpointManager(str(tmp_path / 'checkpoints'),
                                  best_fn=t_det_train.best_fn)
  with pytest.raises(ValueError, match='params.msgpack'):
    t_det_train.load_params(str(tmp_path))


def test_trainer_resumes_from_the_latest_and_restores_the_best(tmp_path):
  config = t_det_train.Config(
      workdir=str(tmp_path), batch_size=2, epochs=2, steps_per_epoch=1,
      eval_steps=1, image_size=32, features=(8, 16), grid_columns=20)
  history = []
  state = t_det_train.train(config, device='cpu',
                            progress=lambda e, m: history.append((e, m)))
  assert [e for e, _ in history] == [0, 1]
  manager = training.manager(str(tmp_path), t_det_train.best_fn)
  assert manager.all_steps() == [0, 1]
  best = manager.best_step()
  accuracies = [m['accuracy'] for _, m in history]
  assert best == (1 if accuracies[1] >= accuracies[0] else 0)
  # The best checkpoint is what load_params returns (no params.msgpack).
  params = t_det_train.load_params(str(tmp_path))
  want = manager.restore(best)['model']
  got = t_det_train.model_lib.params_from_flax(params)
  for key, value in want.items():
    assert torch.equal(got[key], value), key
  # Resume: a longer run starts after the latest kept step, from its state.
  resumed = []
  more = t_det_train.train(
      t_det_train.Config(**{**config.__dict__, 'epochs': 3}), device='cpu',
      progress=lambda e, m: resumed.append(e))
  assert resumed == [2]
  assert training.manager(str(tmp_path), t_det_train.best_fn).all_steps() == [
      0, 1, 2]
  del state, more


def test_a_stop_hook_ends_the_run_before_an_epoch(tmp_path):
  config = t_det_train.Config(
      workdir=str(tmp_path), batch_size=2, epochs=5, steps_per_epoch=1,
      eval_steps=1, image_size=32, features=(8, 16), grid_columns=20)
  calls = []
  t_det_train.train(config, device='cpu',
                    progress=lambda e, m: calls.append(e),
                    stop_fn=lambda: len(calls) >= 2)
  assert calls == [0, 1]
