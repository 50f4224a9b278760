"""LearnedRatePredictor: train, distill, save, load and predict; the planners'
rate function (port of putting_dune_tpu/rate_learning/predictor.py).

`as_rate_function()` returns a batched tensor rate function that the
planners and the KMC engine call like the analytic laws of `rates.py`.
Checkpoints are flax's: `{step}.ckpt` (params), `{step}.state.ckpt`
(batch_stats) and `config.json`, each leaf stacked on a model axis, so
the two packages read each other's files. The TF SavedModel export waits
with the other host modules.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch.io import serialization
from putting_dune_torch.rate_learning import config as config_lib
from putting_dune_torch.rate_learning import data_utils
from putting_dune_torch.rate_learning import distill as distill_lib
from putting_dune_torch.rate_learning import losses
from putting_dune_torch.rate_learning import model as model_lib
from putting_dune_torch.rate_learning import train as train_lib


class LearnedRatePredictor:
  """An ensemble (or distilled single) neural transition-rate model.

  device: where the model lives and runs (CUDA unless asked otherwise).
  generator / seed: the stream every draw (initialisation, shuffles,
  distillation batches) comes from; a generator on `device` wins over
  the seed.
  """

  def __init__(
      self,
      generator: Optional[torch.Generator] = None,
      num_states: int = 3,
      position_dim: int = 2,
      config: config_lib.RateLearningConfig = config_lib.RateLearningConfig(),
      device=None,
      seed: int = 0,
  ):
    self.device = device_lib.resolve_device(device)
    self.generator = (generator if generator is not None else
                      torch.Generator(device=self.device).manual_seed(seed))
    self.num_states = num_states
    self.position_dim = position_dim
    self._build(config, config.num_models)

  def _build(self, config, num_models, context_dim: Optional[int] = None):
    self.config = config
    self.num_models = num_models
    self.context_dim = context_dim or (
        self.position_dim + int(config.use_current) + int(config.use_voltage))
    self.model = model_lib.RateMLP(
        num_models, self.context_dim, config.hidden_dimensions,
        self.num_states, config.batchnorm, config.dropout_rate,
        device=self.device, generator=self.generator).eval()

  # -- inference --------------------------------------------------------------

  def apply_model(self, x, model_index: Optional[int] = None
                  ) -> torch.Tensor:
    """Mean per-neighbor rates over the ensemble (or of one member) for
    contexts x (B, context_dim)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
    model = self.model if model_index is None else self.model.select(
        model_index)
    with torch.no_grad():
      out = model(x, is_training=False)
    return losses.predicted_rates_to_per_neighbor(out).mean(0)

  def _context(self, beam: torch.Tensor, voltage_kv: float,
               current_na: float) -> torch.Tensor:
    """[current, voltage, beam...], each present as the config says: the
    voltage is prepended first, then the current, as the JAX package does."""
    batch = beam.shape[0]
    context = beam
    if self.config.use_voltage:
      context = torch.cat([torch.full((batch, 1), float(voltage_kv),
                                      device=beam.device), context], dim=-1)
    if self.config.use_current:
      context = torch.cat([torch.full((batch, 1), float(current_na),
                                      device=beam.device), context], dim=-1)
    return context

  def _beam_scale(self) -> float:
    return (1.0 / constants.CARBON_BOND_DISTANCE_ANGSTROMS
            if self.config.beam_units == 'bonds' else 1.0)

  def predict(self, beam_position: np.ndarray, silicon_position: np.ndarray,
              neighbor_positions: np.ndarray, voltage_kv: float = 60.0,
              current_na: float = 0.1) -> np.ndarray:
    """Host-side single-step prediction: (3,) rates ordered like the input
    neighbors, from positions in the material frame (angstroms)."""
    rel_neighbors = (np.asarray(neighbor_positions)
                     - np.asarray(silicon_position))
    rel_beam = (np.asarray(beam_position) - np.asarray(silicon_position)
                ) * self._beam_scale()
    new_beam, _, order = data_utils.standardize_beam_and_neighbors(
        rel_beam, rel_neighbors)
    beam = torch.as_tensor(new_beam.reshape(1, -1), dtype=torch.float32,
                           device=self.device)
    context = self._context(beam, voltage_kv, current_na)
    rates = self.apply_model(context).cpu().numpy()[0]
    return rates[np.argsort(order)]

  def as_rate_function(self, voltage_kv: float = 60.0,
                       current_na: float = 0.1):
    """A batched RateFunction (si_pos (B, 2), neighbor_pos (B, 3, 2),
    beam_pos (B, 2)) -> (B, 3) on the model's device: canonicalise, run
    the ensemble, average, and put the rates back in the input neighbors'
    order."""
    model = self.model
    beam_scale = self._beam_scale()

    def rate_fn(si_pos, neighbor_pos, beam_pos):
      rel_neighbors = neighbor_pos - si_pos[:, None, :]
      rel_beam = (beam_pos - si_pos) * beam_scale
      new_beam, _, order = data_utils.standardize_batched(rel_beam,
                                                          rel_neighbors)
      context = self._context(new_beam, voltage_kv, current_na)
      with torch.no_grad():
        out = model(context, is_training=False)
      rates = losses.predicted_rates_to_per_neighbor(out).mean(0)  # (B, 3)
      inverse = torch.argsort(order, dim=-1)
      return torch.gather(rates, 1, inverse)

    return rate_fn

  # -- training ---------------------------------------------------------------

  def train(self, train_data: Mapping[str, np.ndarray],
            bootstrap: Optional[bool] = None, mesh=None,
            epoch_chunk: Optional[int] = None, progress=None):
    """Trains the bootstrap ensemble on `train_data` (host arrays or
    tensors: next_state, dt, rates, position, context). It starts from the
    ensemble the predictor holds, freshly initialised at construction (the
    JAX package draws a fresh one here, from the same law), or from a fresh
    one of config.num_models when the predictor holds another number of
    models (after `distill` or `load`) or another input width than the
    data's. With `mesh` (a 'model' axis) each rank trains its slice of
    the ensemble and ends holding all of it (train.train_multiple_models).
    Returns the metrics {name: (M, epochs)}."""
    if bootstrap is None:
      bootstrap = self.config.bootstrap
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in train_data.items()}
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                             device=self.device))
    train_sets, test_sets = train_lib.create_dataset_splits(
        host, self.config.num_models, seed=seed, bootstrap=bootstrap,
        augment=self.config.augment_data, test_fraction=self.config.val_frac)
    # The data's width wins, as in the JAX package, whose trainer draws
    # its ensemble for the data (a dwell column in the context, say).
    width = (host['context'].reshape(len(host['context']), -1).shape[1]
             + host['position'].shape[-1])
    if (self.num_models != self.config.num_models
        or width != self.context_dim):
      self._build(self.config, self.config.num_models, width)
    self.model, _, metrics = train_lib.train_multiple_models(
        train_sets, test_sets, self.generator, self.config.num_models,
        self.config, epoch_chunk=epoch_chunk, progress=progress,
        device=self.device, model=self.model, mesh=mesh)
    self.model.eval()
    return metrics

  def distill(self, train_data: Mapping[str, np.ndarray],
              config: config_lib.DistillConfig = config_lib.DistillConfig()):
    """Distills the ensemble into one model; returns {'distill_loss'}."""
    def host(key):
      v = train_data[key]
      return (v.cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)).astype(np.float32)

    context = host('context').reshape(len(train_data['context']), -1)
    position = host('position')
    data_mean = np.concatenate([context.mean(0), position.mean(0)], 0)
    data_scale = np.concatenate([context.std(0), position.std(0)], 0)
    self.model, metrics = distill_lib.distill_multiple_models_to_single(
        self.generator, self.model, config.batch_size, config.epochs,
        config.batches_per_epoch,
        torch.as_tensor(data_mean, device=self.device),
        torch.as_tensor(data_scale, device=self.device),
        self.config.learning_rate, self.config.weight_decay)
    self.num_models = 1
    return metrics

  # -- persistence ------------------------------------------------------------

  def save(self, save_dir: str, step: int = 0) -> None:
    """Writes flax `{step}.ckpt`, `{step}.state.ckpt` and config.json."""
    os.makedirs(save_dir, exist_ok=True)
    params, stats = self.model.flax_trees()
    with open(os.path.join(save_dir, f'{step}.ckpt'), 'wb') as f:
      f.write(serialization.to_bytes(params))
    with open(os.path.join(save_dir, f'{step}.state.ckpt'), 'wb') as f:
      f.write(serialization.to_bytes(stats))
    config_dict = {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(self.config).items()}
    config_dict['num_models_current'] = self.num_models
    with open(os.path.join(save_dir, 'config.json'), 'w') as f:
      json.dump(config_dict, f)

  def export_tf(self, save_dir: str, fixed_context=None) -> None:
    """Exports the ensemble-mean predictor as a TF SavedModel (input
    `beam_position` of shape (1, input_dim)), as the JAX package's
    `export_tf` does; `fixed_context`, if given, is prepended to every
    input row."""
    from putting_dune_torch.io import tf_export

    if fixed_context is None:
      input_dim = self.context_dim
    else:
      fixed_context = torch.as_tensor(
          np.asarray(fixed_context, np.float32), device=self.device)
      input_dim = self.context_dim - fixed_context.shape[0]
    tf_export.export_tf_saved_model(
        _EnsembleMean(self.model.eval(), fixed_context), (1, input_dim),
        save_dir, input_name='beam_position')

  def load(self, load_dir: str, step: int = 0) -> None:
    """Reads what `save` (of either package) wrote. The stored config and
    `num_models_current` win over this instance's, and the input width is
    the checkpoint's (a classification network's context holds the dwell
    time too)."""
    with open(os.path.join(load_dir, f'{step}.ckpt'), 'rb') as f:
      params = serialization.unpackb(f.read())
    config, num_models = self.config, self.num_models
    config_path = os.path.join(load_dir, 'config.json')
    if os.path.exists(config_path):
      with open(config_path) as f:
        cfg = json.load(f)
      num_models = cfg.pop('num_models_current', cfg.get('num_models'))
      cfg['hidden_dimensions'] = tuple(cfg['hidden_dimensions'])
      config = config_lib.RateLearningConfig(**cfg)
    width = int(np.shape(params['Dense_0']['kernel'])[1])
    if (config != self.config or num_models != self.num_models
        or width != self.context_dim):
      self._build(config, num_models, width)
    stats = {}
    state_path = os.path.join(load_dir, f'{step}.state.ckpt')
    if os.path.exists(state_path):
      with open(state_path, 'rb') as f:
        stats = serialization.unpackb(f.read())
    self.model.load_flax_trees(params, stats or self.model.flax_trees()[1])
    self.model.eval()


class _EnsembleMean(torch.nn.Module):
  """The exported function of `export_tf`: `fixed_context` prepended to
  every row, then the ensemble mean of the per-neighbour rates."""

  def __init__(self, model: torch.nn.Module, fixed_context):
    super().__init__()
    self.model = model
    self.fixed = fixed_context is not None
    if self.fixed:
      self.register_buffer('fixed_context', fixed_context)

  def forward(self, context: torch.Tensor) -> torch.Tensor:
    if self.fixed:
      tiled = self.fixed_context[None].expand(context.shape[0], -1)
      context = torch.cat([tiled, context], dim=-1)
    out = self.model(context, is_training=False)
    return losses.predicted_rates_to_per_neighbor(out).mean(0)


def predictor_from_flax(params: Mapping, state: Mapping,
                        config: config_lib.RateLearningConfig,
                        device=None) -> LearnedRatePredictor:
  """The port's predictor holding a JAX predictor's params and batch_stats
  (numpy trees with a leading model axis, as `LearnedRatePredictor.params`
  and `.state` are there)."""
  num_models, width = np.shape(params['Dense_0']['kernel'])[:2]
  predictor = LearnedRatePredictor(config=config, device=device)
  if (num_models, width) != (predictor.num_models, predictor.context_dim):
    predictor._build(config, int(num_models), int(width))
  predictor.model.load_flax_trees(params, state)
  return predictor
