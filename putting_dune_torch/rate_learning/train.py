"""Training loops of the rate learner: the bootstrap ensemble as one program.

Port of putting_dune_tpu/rate_learning/train.py. The JAX package scans
epochs of scanned minibatch steps and vmaps that over the ensemble; here
the ensemble axis lives in every layer (model.RateMLP), so each step is one
batched forward, backward and AdamW update for all M models, each on its
own minibatch (its own permutation per epoch) with its own batch norm.
Metrics stay on the device within a chunk of epochs; the host reads them
once per chunk. The mesh-sharded ensemble is not ported.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from putting_dune_torch.rate_learning import config as config_lib
from putting_dune_torch.rate_learning import data_utils
from putting_dune_torch.rate_learning import losses
from putting_dune_torch.rate_learning import model as model_lib
from putting_dune_torch.utils import training as training_utils

# The per-epoch metrics use a bounded prefix of each split (the splits are
# shuffled, so a prefix is a random sample): a full-split forward would keep
# (models x examples x hidden) activations alive.
MAX_EVAL_ROWS = 16384

METRIC_NAMES = ('train_loss', 'test_loss', 'train_rate_loss',
                'train_class_loss', 'test_rate_loss', 'test_class_loss')


def tree_stack(list_of_trees):
  """Stacks matching nested dicts leaf by leaf along a new axis 0 (tensors
  with torch.stack, anything else with np.stack)."""
  first = list_of_trees[0]
  if isinstance(first, Mapping):
    return {k: tree_stack([t[k] for t in list_of_trees]) for k in first}
  if isinstance(first, torch.Tensor):
    return torch.stack(list_of_trees, 0)
  return np.stack(list_of_trees, 0)


def _take(data: Mapping[str, torch.Tensor], index: torch.Tensor):
  """Rows `index` (M, n) of each model's (M, N, ...) arrays."""
  out = {}
  for key, array in data.items():
    idx = index if array.dim() == 2 else index[..., None].expand(
        *index.shape, array.shape[-1])
    out[key] = torch.gather(array, 1, idx)
  return out


def train_epoch(model, optimizer, train_data: Mapping[str, torch.Tensor],
                batch_size: int, generator: torch.Generator,
                config: config_lib.RateLearningConfig) -> None:
  """One epoch: each model shuffles its own rows, then floor(N / batch)
  AdamW steps over all models at once. No host sync.

  Gather strategy, from the data's device: on the CPU the shuffled epoch is
  gathered once and the steps take slices of it (per-step gathers dominate
  there, as the JAX package measured); on the card each step gathers its
  (M, batch) rows, one small kernel, and no epoch copy is made. The copy
  would fit on the card too: at production size (40.9k transitions, x6
  augmented = 245.5k rows per model, 50 models) the trained columns
  (next_state int64, dt, 4 context) take 50 x 245.5k x 28 B = 0.34 GB, and
  the epoch copy as much again, of 80 GB.
  """
  next_state = train_data['next_state']
  num_models, data_size = next_state.shape
  num_batches = data_size // batch_size
  device = next_state.device
  perm = torch.argsort(torch.rand((num_models, data_size),
                                  generator=generator, device=device), dim=1)
  batch_inds = perm[:, :num_batches * batch_size].reshape(
      num_models, num_batches, batch_size)
  columns = {k: train_data[k] for k in ('next_state', 'dt', 'context')}
  pregather = device.type == 'cpu'
  if pregather:
    epoch = _take(columns, batch_inds.reshape(num_models, -1))
  for step in range(num_batches):
    if pregather:
      rows = slice(step * batch_size, (step + 1) * batch_size)
      batch = {k: a[:, rows] for k, a in epoch.items()}
    else:
      batch = _take(columns, batch_inds[:, step])
    optimizer.zero_grad(set_to_none=True)
    loss, _ = losses.batched_loss_fn(
        model, batch['next_state'], batch['dt'], batch['next_state'] != 0,
        batch['context'], True, config.class_loss_weight,
        config.rate_loss_weight)
    # The models share no parameter, so the gradient of the sum is each
    # model's own gradient.
    loss.sum().backward()
    optimizer.step()


def _eval_losses(model, data):
  loss, (_, rate_loss, class_loss) = losses.batched_loss_fn(
      model, data['next_state'], data['dt'], data['next_state'] != 0,
      data['context'], is_training=False)
  return loss, rate_loss.mean(-1), class_loss.mean(-1)


def train_model(model, optimizer, train_data, test_data,
                generator: torch.Generator,
                config: config_lib.RateLearningConfig,
                epochs: Optional[int] = None) -> torch.Tensor:
  """`epochs` (default config.epochs) epochs of every model; returns the
  metrics as a device tensor (len(METRIC_NAMES), M, epochs)."""
  epochs = config.epochs if epochs is None else epochs
  train_eval = {k: a[:, :MAX_EVAL_ROWS] for k, a in train_data.items()}
  test_eval = {k: a[:, :MAX_EVAL_ROWS] for k, a in test_data.items()}
  history = []
  for _ in range(epochs):
    model.train()
    train_epoch(model, optimizer, train_data, config.batch_size, generator,
                config)
    model.eval()
    with torch.no_grad():
      train_loss, train_rate, train_class = _eval_losses(model, train_eval)
      test_loss, test_rate, test_class = _eval_losses(model, test_eval)
    history.append(torch.stack([train_loss, test_loss, train_rate,
                                train_class, test_rate, test_class]))
  return torch.stack(history, dim=-1)


def create_dataset_splits(
    train_data: Mapping[str, np.ndarray],
    num_splits: int,
    seed: int,
    bootstrap: bool = True,
    augment: bool = True,
    test_fraction: float = 0.1,
):
  """Bootstrapped (or split) and augmented per-model datasets, stacked on a
  leading model axis, with 'position' folded into 'context' (the model
  input). Host numpy: the same seed gives the JAX package's index sets.
  Returns (train_datasets, test_datasets)."""
  rng = np.random.default_rng(seed)
  train_sets, test_sets = [], []
  for _ in range(num_splits):
    s = int(rng.integers(2**31))
    if bootstrap:
      tr, te = data_utils.bootstrap_dataset(train_data, s)
    elif 0.0 < test_fraction < 1.0:
      tr, te = data_utils.split_dataset(train_data, s, test_fraction)
    else:
      tr, te = dict(train_data), dict(train_data)
    if augment:
      tr, te = _augmented(tr), _augmented(te)
    train_sets.append(tr)
    test_sets.append(te)

  def equalize(sets):
    min_len = min(s['context'].shape[0] for s in sets)
    return [{k: np.asarray(a)[:min_len] for k, a in s.items()} for s in sets]

  def stack_fold(sets):
    out = {}
    for k in sets[0]:
      if sets[0][k] is None:
        continue
      dtype = np.int32 if k == 'next_state' else np.float32
      out[k] = np.stack([np.asarray(s[k]) for s in sets]).astype(dtype)
    if 'position' in out:
      out['context'] = np.concatenate([out['context'], out['position']],
                                      axis=-1)
      del out['position']
    return out

  return (stack_fold(equalize(train_sets)),
          stack_fold(equalize(test_sets)))


def _augmented(d):
  def t(key, dtype):
    return torch.as_tensor(np.asarray(d[key]), dtype=dtype)

  out = data_utils.augment_data(
      next_state=t('next_state', torch.int32).reshape(-1),
      dt=t('dt', torch.float32).reshape(-1),
      rates=t('rates', torch.float32),
      position=t('position', torch.float32),
      context=t('context', torch.float32),
  )
  return {k: v.numpy() for k, v in out.items()}


def to_device(datasets: Mapping[str, np.ndarray], device):
  """Stacked numpy datasets as device tensors (next_state int64)."""
  return {k: torch.as_tensor(np.asarray(a), device=device,
                             dtype=torch.long if k == 'next_state'
                             else torch.float32)
          for k, a in datasets.items()}


def train_multiple_models(
    train_datasets: Mapping[str, np.ndarray],
    test_datasets: Mapping[str, np.ndarray],
    generator: torch.Generator,
    num_models: int,
    config: config_lib.RateLearningConfig,
    epoch_chunk: Optional[int] = None,
    progress: Optional[Callable[[int, Mapping[str, float]], None]] = None,
    device=None,
    model: Optional[model_lib.RateMLP] = None,
):
  """Trains the bootstrap ensemble as one batched program.

  train_datasets / test_datasets: stacked (num_models, N, ...) arrays (from
  `create_dataset_splits`) or tensors. A fresh ensemble is initialised
  from `generator` unless `model` is given. `epoch_chunk` epochs run
  between host reads of the metrics, after each of which
  `progress(epochs_done, last-epoch metrics averaged over models)` is
  called. Returns (model, optimizer, metrics {name: (M, epochs) numpy}).
  """
  from putting_dune_torch import device as device_lib

  device = device_lib.resolve_device(device)
  train = to_device(train_datasets, device)
  test = to_device(test_datasets, device)
  if model is None:
    model = model_lib.RateMLP(
        num_models, train['context'].shape[-1], config.hidden_dimensions,
        config.num_states, config.batchnorm, config.dropout_rate,
        device=device, generator=generator)
  # One AdamW over the stacked (M, ...) parameters is M optimizers.
  optimizer = training_utils.adamw(model, config.learning_rate,
                                   config.weight_decay)
  total = config.epochs
  chunk = min(epoch_chunk or total, total)
  parts, done = [], 0
  while done < total:
    this_chunk = min(chunk, total - done)
    part = train_model(model, optimizer, train, test, generator, config,
                       epochs=this_chunk).cpu().numpy()
    parts.append(part)
    done += this_chunk
    if progress is not None:
      progress(done, {name: float(part[i, :, -1].mean())
                      for i, name in enumerate(METRIC_NAMES)})
  history = np.concatenate(parts, axis=-1)
  metrics = {name: history[i] for i, name in enumerate(METRIC_NAMES)}
  return model, optimizer, metrics
