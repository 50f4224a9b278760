"""Graph-alignment training: drift loss on generated point clouds,
best-of-3 checkpoints, and the params artifact.

Port of putting_dune_tpu/graph_alignment/train.py. The loss is the mean
summed square of the global head's (B, T, 2) drifts against the labels,
plus local_loss_weight times the mean square of the masked local head;
`drift_error` is the mean norm. optax's adamw as a torch AdamW
(`utils/training.adamw`), full float32 (TF32 off). No kernel runs on
this path: the point clouds come from the simulator's atom windows, or
with data_source='records:<dir>' from a written dataset (eval on its
`test/` split where it has one).

  python -m putting_dune_torch.graph_alignment.train --workdir=runs/gnn \
      --epochs=1 --steps_per_epoch=2 --eval_steps=1 [--device=cpu]

`train(config, mesh=)` trains data-parallel over the mesh's ranks
(utils/training.py); the CLI's --coordinator_address, --num_processes and
--process_id (or torchrun's environment) form the world.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from putting_dune_torch import device as device_lib
from putting_dune_torch.agents import ppo
from putting_dune_torch.graph_alignment import data as data_lib
from putting_dune_torch.graph_alignment import model as model_lib
from putting_dune_torch.io import serialization
from putting_dune_torch.utils import training

TrainState = training.TrainState


@dataclasses.dataclass(frozen=True)
class Config:
  """Train config; the JAX package's fields and defaults (which describe
  the shipped graph_aligner)."""

  workdir: str
  seed: int = 0
  learning_rate: float = 1e-3
  batch_size: int = 16
  epochs: int = 100
  steps_per_epoch: int = 100
  eval_steps: int = 20
  num_frames: int = 2
  capacity: int = 256
  width: int = 64
  num_layers: int = 3
  k: int = 8
  local_loss_weight: float = 0.0
  grid_columns: int = 50
  # 'synthetic' (generated clouds) or 'records:<dir>' (a written dataset).
  data_source: str = 'synthetic'


def best_fn(metrics) -> float:
  return -metrics['drift_error']


def _loss(model, batch, local_loss_weight: float):
  """(total, {'loss', 'drift_error'}) of `model` on a batch."""
  global_out, local_out = model_lib.batched_apply(model, batch)
  diff = global_out - batch['drift']
  total = torch.mean(torch.sum(torch.square(diff), -1))
  drift_error = torch.mean(torch.linalg.vector_norm(diff.detach(), dim=-1))
  if local_loss_weight > 0:
    # Unjittered clouds want a small per-node displacement.
    total = total + local_loss_weight * torch.mean(
        torch.square(local_out) * batch['mask'][..., None])
  return total, {'loss': total.detach(), 'drift_error': drift_error}


def train_step(state: TrainState, batch, local_loss_weight: float = 0.0,
               mesh=None):
  """One AdamW step in place (gradients averaged over the mesh's ranks);
  returns (state, {'loss', 'drift_error'})."""
  with training.precision():
    total, metrics = _loss(state.model, batch, local_loss_weight)
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
  training.apply_gradients(state, mesh)
  return state, metrics


def eval_step(state: TrainState, batch) -> dict:
  with torch.no_grad(), training.precision():
    return _loss(state.model, batch, 0.0)[1]


def create_model(config: Config) -> model_lib.AlignmentGraphNetwork:
  return model_lib.AlignmentGraphNetwork(
      num_frames=config.num_frames, width=config.width,
      num_layers=config.num_layers, k=config.k)


def create_state(config: Config, device=None) -> TrainState:
  """The network with flax's initialisers (drawn on the CPU from
  config.seed) and its AdamW, on `device` (CUDA unless 'cpu')."""
  device = device_lib.resolve_device(device)
  model = create_model(config)
  ppo.flax_init_(model, torch.Generator().manual_seed(config.seed))
  model.to(device)
  return TrainState(model, training.adamw(model, config.learning_rate))


def _summarize(train_metrics, eval_metrics) -> dict:
  if eval_metrics:
    return training.mean_metrics(eval_metrics)
  return training.last_metrics(train_metrics)


def train(config: Config, *, device=None, mesh=None, progress=None,
          stop_fn=None) -> TrainState:
  """Runs the training loop with best-checkpoint retention (see
  `utils/training.run_epochs`); with `mesh`, data-parallel."""
  training.check_config(config)
  device = device_lib.resolve_device(device if mesh is None else mesh.device)
  state = create_state(config, device)
  stream = dict(batch_size=training.local_batch_size(config),
                num_frames=config.num_frames,
                capacity=config.capacity, grid_columns=config.grid_columns,
                device=device)
  train_iter, eval_iter = training.data_streams(
      config, data_lib, device,
      lambda seed, train: data_lib.dataset_iterator(seed, **stream))
  return training.run_epochs(
      config, state, best_fn, train_iter, eval_iter,
      lambda s, b: train_step(s, b, config.local_loss_weight, mesh)[1],
      eval_step, _summarize, progress=progress, stop_fn=stop_fn, mesh=mesh)


def save_params_msgpack(params, workdir: str) -> str:
  """Writes `workdir`/params.msgpack, the flax bytes of a params tree (or
  of an AlignmentGraphNetwork's)."""
  if isinstance(params, torch.nn.Module):
    params = model_lib.params_to_flax(params)
  return serialization.write_params(params, workdir)


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

  cli.run_train_cli(Config, train, 'Train the GNN point-cloud aligner.')
