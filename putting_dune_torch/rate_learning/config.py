"""Training configs of the rate learner (port of
putting_dune_tpu/rate_learning/config.py: the same fields and defaults)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RateLearningConfig:
  batch_size: int = 256
  epochs: int = 500
  num_models: int = 50
  bootstrap: bool = True
  hidden_dimensions: tuple[int, ...] = (256, 256)
  weight_decay: float = 1e-3
  learning_rate: float = 1e-3
  val_frac: float = 0.0
  use_voltage: bool = True
  use_current: bool = True
  dwell_time_in_context: bool = False
  class_loss_weight: float = 1.0
  rate_loss_weight: float = 1.0
  augment_data: bool = True
  batchnorm: bool = True
  dropout_rate: float = 0.0
  num_states: int = 3
  # Units of the canonical beam offset the model was trained on: 'bonds'
  # for synthetic prior data (positions in bond lengths), 'angstroms' for
  # transitions from the pipeline (raw angstrom offsets; the shipped
  # predictor's config.json says so).
  beam_units: str = 'bonds'


@dataclasses.dataclass(frozen=True)
class DistillConfig:
  batch_size: int = 4096
  epochs: int = 10_000
  batches_per_epoch: int = 10
