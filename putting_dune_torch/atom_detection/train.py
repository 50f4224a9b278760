"""Atom-detection training: the UNet on generated scenes, best-of-3
checkpoints, and its artifacts.

Port of putting_dune_tpu/atom_detection/train.py. A step is softmax cross
entropy against the one-hot mask (class-weighted when `class_weights` is
set: sum(ce * w) / max(sum(w), 1)), argmax accuracy, and optax's
`adamw(learning_rate)` as a torch AdamW (`utils/training.adamw`). The
scenes come from `data.dataset_iterator` on the device (the noise chain
and CLAHE kernels at every batch); the best checkpoint by eval accuracy is
kept with `utils/checkpoints.CheckpointManager`, which stands in for
orbax. Training runs in full float32 (TF32 off) unless a step is asked
for TF32.

Artifacts: `save_params_msgpack` writes the flax bytes the JAX package
reads (`params.msgpack`) and the `arch.json` sidecar; `load_params` reads
`params.msgpack`, or else the port's best checkpoint, as a flax tree.

  python -m putting_dune_torch.atom_detection.train --workdir=runs/det \
      --epochs=1 --steps_per_epoch=2 --eval_steps=1 [--device=cpu]

Not ported: `data_source='records:...'` (the IO slice) and `mesh=` (the
multi-GPU slice).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from putting_dune_torch import device as device_lib
from putting_dune_torch.agents import ppo
from putting_dune_torch.atom_detection import data as data_lib
from putting_dune_torch.atom_detection import model as model_lib
from putting_dune_torch.io import serialization
from putting_dune_torch.io.serialization import load_arch  # noqa: F401
from putting_dune_torch.utils import training

TrainState = training.TrainState


@dataclasses.dataclass(frozen=True)
class Config:
  """Train config; the JAX package's fields and defaults."""

  workdir: str
  seed: int = 0
  learning_rate: float = 1e-3
  batch_size: int = 128
  epochs: int = 100
  steps_per_epoch: int = 500  # batches per epoch
  eval_steps: int = 50
  image_size: int = 128
  features: tuple = (32, 64, 128, 256)
  grid_columns: int = 50
  noisy_images: bool = False
  # The train stream's per-batch probability of a fully noisy batch (eval
  # keeps noisy_images).
  noisy_fraction: Optional[float] = None
  # Per-class CE weights (background, carbon, silicon).
  class_weights: Optional[tuple] = None
  # Warm-start params from this workdir (params.msgpack, or its best
  # checkpoint) when the run has no checkpoint of its own yet.
  init_params_from: str = ''
  # Only 'synthetic' is ported; 'records:<dir>' waits for the IO slice.
  data_source: str = 'synthetic'


def best_fn(metrics) -> float:
  return metrics['accuracy']


def _accuracy(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  return torch.mean((logits.argmax(-1) == mask.argmax(-1)).float())


def loss_and_accuracy(model, batch, class_weights=None):
  """(loss, accuracy) of `model` on a batch {image, mask}."""
  logits = model(batch['image'])
  ce = -torch.sum(batch['mask'] * F.log_softmax(logits, -1), -1)
  if class_weights is not None:
    weights = batch['mask'] @ torch.as_tensor(
        class_weights, dtype=logits.dtype, device=logits.device)
    loss = torch.sum(ce * weights) / torch.clamp(torch.sum(weights), min=1.0)
  else:
    loss = torch.mean(ce)
  return loss, _accuracy(logits.detach(), batch['mask'])


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               class_weights: Optional[tuple] = None,
               allow_tf32: bool = False):
  """One AdamW step in place; returns (state, {'loss', 'accuracy'}). The
  gradients stay in the parameters' `.grad`."""
  with training.precision(allow_tf32):
    loss, accuracy = loss_and_accuracy(state.model, batch, class_weights)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
  training.apply_gradients(state)
  return state, {'loss': loss.detach(), 'accuracy': accuracy}


def eval_step(state: TrainState,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
  """Pixel accuracy of the argmax against the mask."""
  with torch.no_grad(), training.precision():
    return _accuracy(state.model(batch['image']), batch['mask'])


def create_state(config: Config, device=None) -> TrainState:
  """A UNet with flax's initialisers (drawn on the CPU from config.seed)
  and its AdamW, on `device` (CUDA unless 'cpu')."""
  device = device_lib.resolve_device(device)
  model = model_lib.UNet(features=tuple(config.features))
  ppo.flax_init_(model, torch.Generator().manual_seed(config.seed))
  model.to(device)
  return TrainState(model, training.adamw(model, config.learning_rate))


def _summarize(train_metrics, eval_metrics) -> dict:
  """The JAX summary: train loss and accuracy where there were train
  steps; `accuracy` the eval mean, or the train accuracy without evals."""
  summary = {}
  if train_metrics:
    means = training.mean_metrics(train_metrics)
    summary['loss'] = means['loss']
    summary['train_accuracy'] = means['accuracy']
  summary['accuracy'] = (
      training.mean_metrics([{'accuracy': a} for a in eval_metrics])
      ['accuracy'] if eval_metrics else summary['train_accuracy'])
  return summary


def train(config: Config, *, device=None, progress=None,
          stop_fn=None) -> TrainState:
  """Runs the training loop with best-checkpoint retention (see
  `utils/training.run_epochs`); `progress(epoch, summary)` after each
  epoch, `stop_fn()` true before an epoch stops the run."""
  training.check_config(config)
  device = device_lib.resolve_device(device)
  state = create_state(config, device)
  if config.init_params_from:
    warm = load_params(config.init_params_from)
    state.model.load_state_dict(model_lib.params_from_flax(warm))
  train_iter = data_lib.dataset_iterator(
      config.seed, noisy_fraction=config.noisy_fraction,
      batch_size=config.batch_size, image_size=config.image_size,
      grid_columns=config.grid_columns, noisy=config.noisy_images,
      device=device)
  eval_iter = data_lib.dataset_iterator(
      config.seed + 1, batch_size=config.batch_size,
      image_size=config.image_size, grid_columns=config.grid_columns,
      noisy=config.noisy_images, device=device)
  return training.run_epochs(
      config, state, best_fn, train_iter, eval_iter,
      lambda s, b: train_step(s, b, config.class_weights)[1],
      eval_step, _summarize, progress=progress, stop_fn=stop_fn)


def save_params_msgpack(params, workdir: str,
                        config: Optional[Config] = None) -> str:
  """Writes `workdir`/params.msgpack, the flax bytes of a params tree (or
  of a UNet's), and with `config` the arch.json sidecar {'features',
  'image_size'}."""
  if isinstance(params, torch.nn.Module):
    params = model_lib.params_to_flax(params)
  path = serialization.write_params(params, workdir)
  if config is not None:
    serialization.write_arch(workdir, {'features': list(config.features),
                         'image_size': config.image_size})
  return path


def load_params(workdir: str, config: Optional[Config] = None) -> dict:
  """The flax parameter tree: `workdir`/params.msgpack if present, else
  the best checkpoint the port's trainer kept there. `config` is accepted
  for the JAX signature; the tree's shapes come from the file."""
  del config
  params = serialization.read_params_msgpack(workdir)
  if params is not None:
    return params
  return model_lib.params_to_flax(
      training.restore_best(workdir, best_fn, map_location='cpu'))


if __name__ == '__main__':
  from putting_dune_torch.utils import cli

  cli.run_train_cli(Config, train, 'Train the atom-detection UNet.')
