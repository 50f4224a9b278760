"""Image-alignment training: segmentation CE + weighted drift loss on
generated drifting stacks, best-of-3 checkpoints, and its artifacts.

Port of putting_dune_tpu/image_alignment/train.py. `_losses` reshapes the
local logits frame-major to (B, S, S, T, 3) for the softmax cross entropy
and accuracy, and reads the global head as (B, T, 2) drifts: `drift_loss`
the mean summed square, `drift_error` the mean norm, both over the final
frame only with `final_step_only`. A step minimizes ce_loss_weight * ce +
drift_loss_weight * drift_loss with optax's adamw (`utils/training.adamw`)
in full float32 (TF32 off). The stacks come
from `data.dataset_iterator` on the device (`noise_chain` and
`clahe_small` each frame; `clahe_small` twice with
inference_preprocessing). The best checkpoint by -drift_error is kept.

  python -m putting_dune_torch.image_alignment.train --workdir=runs/align \
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
from putting_dune_torch.image_alignment import data as data_lib
from putting_dune_torch.image_alignment import model as model_lib
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
  batch_size: int = 32
  epochs: int = 1000
  steps_per_epoch: int = 100
  eval_steps: int = 20
  image_size: int = 128
  num_frames: int = 5
  features: tuple = (32, 64, 128, 256)
  drift_loss_weight: float = 1.0
  final_step_only: bool = False
  grid_columns: int = 50
  noisy_images: bool = False
  # The train stream's per-batch probability of fully noisy stacks.
  noisy_fraction: Optional[float] = None
  # > 0: the inference-matched protocol (data.sample_stack).
  registration_noise: float = 0.0
  # Equalize and min-max each frame again, as the aligner does.
  inference_preprocessing: bool = False
  # Share of registration-mode samples with a self-seeded history.
  seed_fraction: float = 0.0
  # Warm-start params from this workdir when the run has no checkpoint.
  init_params_from: str = ''
  # Only 'synthetic' is ported; 'records:<dir>' waits for the IO slice.
  data_source: str = 'synthetic'
  # Weight on the segmentation CE (0 for real trajectories, maskless).
  ce_loss_weight: float = 1.0


def best_fn(metrics) -> float:
  return -metrics['drift_error']


def _losses(model, batch, num_frames: int, final_step_only: bool):
  """(ce, accuracy, drift_loss, drift_error) of `model` on a batch."""
  logits, pred_drift = model(batch['images'])
  b, h, w, _ = logits.shape
  logits = logits.reshape(b, h, w, num_frames, 3)
  mask = batch['mask'].reshape(b, h, w, num_frames, 3)
  ce = torch.mean(-torch.sum(mask * F.log_softmax(logits, -1), -1))
  accuracy = torch.mean(
      (logits.detach().argmax(-1) == mask.argmax(-1)).float())
  diff = batch['drift'] - pred_drift.reshape(batch['drift'].shape)
  drift_sq = torch.sum(torch.square(diff), -1)  # (B, T)
  drift_err = torch.linalg.vector_norm(diff.detach(), dim=-1)
  if final_step_only:
    return ce, accuracy, drift_sq[..., -1].mean(), drift_err[..., -1].mean()
  return ce, accuracy, drift_sq.mean(), drift_err.mean()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               drift_loss_weight: float, num_frames: int,
               final_step_only: bool, ce_loss_weight: float = 1.0):
  """One AdamW step in place; returns (state, {'loss', 'ce', 'accuracy',
  'drift_loss', 'drift_error'})."""
  with training.precision():
    ce, accuracy, drift_loss, drift_error = _losses(
        state.model, batch, num_frames, final_step_only)
    total = ce_loss_weight * ce + drift_loss_weight * drift_loss
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
  training.apply_gradients(state)
  return state, {'loss': total.detach(), 'ce': ce.detach(),
                 'accuracy': accuracy, 'drift_loss': drift_loss.detach(),
                 'drift_error': drift_error}


def eval_step(state: TrainState, batch, num_frames: int,
              final_step_only: bool) -> dict:
  with torch.no_grad(), training.precision():
    ce, accuracy, drift_loss, drift_error = _losses(
        state.model, batch, num_frames, final_step_only)
  return {'ce': ce, 'accuracy': accuracy, 'drift_loss': drift_loss,
          'drift_error': drift_error}


def create_model(config: Config) -> model_lib.GlobalLocalUNet:
  return model_lib.GlobalLocalUNet(
      local_output_size=3 * config.num_frames,
      global_output_size=2 * config.num_frames,
      features=tuple(config.features), in_channels=config.num_frames)


def create_state(config: Config, device=None) -> TrainState:
  """A GlobalLocalUNet with flax's initialisers (drawn on the CPU from
  config.seed) and its AdamW, on `device` (CUDA unless 'cpu')."""
  device = device_lib.resolve_device(device)
  model = create_model(config)
  ppo.flax_init_(model, torch.Generator().manual_seed(config.seed))
  model.to(device)
  return TrainState(model, training.adamw(model, config.learning_rate))


def _summarize(train_metrics, eval_metrics) -> dict:
  """The eval means, or the last train step's metrics without evals."""
  if eval_metrics:
    return training.mean_metrics(eval_metrics)
  return training.last_metrics(train_metrics)


def train(config: Config, *, device=None, progress=None,
          stop_fn=None) -> TrainState:
  """Runs the training loop with best-checkpoint retention (see
  `utils/training.run_epochs`)."""
  training.check_config(config)
  device = device_lib.resolve_device(device)
  state = create_state(config, device)
  if config.init_params_from:
    state.model.load_state_dict(
        model_lib.params_from_flax(load_params(config.init_params_from)))
  stream = dict(
      batch_size=config.batch_size, image_size=config.image_size,
      num_frames=config.num_frames, grid_columns=config.grid_columns,
      registration_noise=config.registration_noise,
      inference_preprocessing=config.inference_preprocessing,
      seed_fraction=config.seed_fraction, device=device)
  train_iter = data_lib.dataset_iterator(
      config.seed, noisy=config.noisy_images,
      noisy_fraction=config.noisy_fraction, **stream)
  eval_iter = data_lib.dataset_iterator(
      config.seed + 1, noisy=config.noisy_images, **stream)
  step = lambda s, b: train_step(  # noqa: E731
      s, b, config.drift_loss_weight, config.num_frames,
      config.final_step_only, config.ce_loss_weight)[1]
  evaluate = lambda s, b: eval_step(  # noqa: E731
      s, b, config.num_frames, config.final_step_only)
  return training.run_epochs(
      config, state, best_fn, train_iter, eval_iter, step, evaluate,
      _summarize, progress=progress, stop_fn=stop_fn)


def save_params_msgpack(params, workdir: str,
                        config: Optional[Config] = None) -> str:
  """Writes `workdir`/params.msgpack (flax bytes of a params tree or of a
  GlobalLocalUNet's) and with `config` the arch.json sidecar {'features',
  'num_frames', 'image_size'}."""
  if isinstance(params, torch.nn.Module):
    params = model_lib.params_to_flax(params)
  path = serialization.write_params(params, workdir)
  if config is not None:
    serialization.write_arch(workdir, {
        'features': list(config.features), 'num_frames': config.num_frames,
        'image_size': config.image_size})
  return path


def load_params(workdir: str, config: Optional[Config] = None) -> dict:
  """The flax parameter tree: `workdir`/params.msgpack if present, else
  the best checkpoint the port's trainer kept there."""
  del config
  params = serialization.read_params_msgpack(workdir)
  if params is not None:
    return params
  return model_lib.params_to_flax(
      training.restore_best(workdir, best_fn, map_location='cpu'))


if __name__ == '__main__':
  from putting_dune_torch.utils import cli

  cli.run_train_cli(Config, train, 'Train the image-alignment network.')
