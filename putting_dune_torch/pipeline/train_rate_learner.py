"""Rate-model training from recorded trajectories.

Port of putting_dune_tpu/pipeline/train_rate_learner.py: transition
filtering and canonicalisation into DataPoints, dataset stacking, and the
neural rate-network path (train the bootstrap ensemble -> metrics ->
distill -> save) on the port's `rate_learning/`. The saved predictor is
the flax checkpoint both packages read (`LearnedRatePredictor.save`).

  python -m putting_dune_torch.pipeline.train_rate_learner \
      --source_path=trajectories.tfrecords --workdir=runs/rates [--device=cpu]

With the default flags it writes, as the JAX CLI does, `metrics.npz`, one
`{k}.png` per metric (--plot_metrics) and `avg_context_rates.png`, the
final predictor's rates over a 300^2 grid of beams at the median context
(--visualize_rates), drawn by plotting_utils without matplotlib. The five
sklearn learner types (ROADMAP queue 1, IO: the sklearn learners) are not
ported: they raise NotImplementedError before any training.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import microscope_data as md
from putting_dune_torch import plotting_utils
from putting_dune_torch.io import records
from putting_dune_torch.pipeline import trajectories_to_transitions as t2t
from putting_dune_torch.rate_learning import config as config_lib
from putting_dune_torch.rate_learning import data_utils
from putting_dune_torch.rate_learning import predictor as predictor_lib


class LearnerType(str, enum.Enum):
  RATE_NETWORK = 'rate_network'
  CLASSIFICATION_NETWORK = 'classification_network'
  SKLEARN_MLP = 'sklearn_mlp'
  KNN = 'knn'
  GP = 'gp'
  RANDOM_FOREST = 'random_forest'
  SVM = 'svm'


_NETWORK_TYPES = (LearnerType.RATE_NETWORK,
                  LearnerType.CLASSIFICATION_NETWORK)


@dataclasses.dataclass
class Args:
  """The JAX package's fields and defaults, and the device."""

  source_path: str
  workdir: str
  log_metrics: bool = True
  plot_metrics: bool = True
  visualize_rates: bool = True
  batch_size: int = 256
  epochs: int = 500
  # Epochs between host reads of the metrics (progress lines).
  epoch_chunk: int = 50
  num_models: int = 100
  bootstrap: bool = True
  hidden_dimensions: Tuple[int, ...] = (128, 128)
  weight_decay: float = 1e-1
  learning_rate: float = 1e-3
  val_frac: float = 0.0
  neighbor_distance_cutoff: float = (
      constants.CARBON_BOND_DISTANCE_ANGSTROMS / 2
  )
  seed: int = 42
  distill: bool = True
  augment_data: bool = True
  use_voltage: bool = True
  use_current: bool = True
  batchnorm: bool = True
  dropout_rate: float = 0.0
  class_loss_weight: float = 0.1
  rate_loss_weight: float = 1.0
  previous_controls_at_current_timestep: bool = False
  learner_type: str = 'rate_network'
  device: Optional[str] = None


@dataclasses.dataclass
class DataPoint:
  """One canonicalized transition."""

  next_state: int
  beam_pos: np.ndarray
  seconds_between: float
  current: Optional[float]
  voltage: Optional[float]


def transitions_to_datapoints(
    transitions: Sequence[md.Transition],
    *,
    neighbor_distance_cutoff: float = (
        constants.CARBON_BOND_DISTANCE_ANGSTROMS / 2
    ),
) -> Tuple[List[DataPoint], Dict[str, int]]:
  """Filters and canonicalizes transitions for rate learning.

  The filter: a single control; exactly one silicon before AND after;
  threefold (not fourfold) local coordination; consistent neighbor sets
  across the pair; the successor identified by the nearest
  before-neighbor to the after-silicon; beam standardized to the
  canonical frame (neighbor nearest the beam on +x).

  Returns (datapoints, drop-reason counts).
  """
  counts = {
      'no_controls': 0,
      'wrong_number_of_silicons': 0,
      'no_silicon_neighbor': 0,
      'wrong_number_of_neighbors': 0,
      'fourfold': 0,
      'not_threefold': 0,
      'neighbors_too_distant': 0,
      'kept': 0,
  }
  data: List[DataPoint] = []

  for transition in transitions:
    if len(transition.controls) != 1:
      counts['no_controls'] += 1
      continue
    control = transition.fov_before.microscope_frame_to_material_frame(
        transition.controls[0]
    )
    grid_before = transition.fov_before.microscope_frame_to_material_frame(
        transition.grid_before
    )
    grid_after = transition.fov_after.microscope_frame_to_material_frame(
        transition.grid_after
    )

    si_before = grid_before.atom_positions[
        grid_before.atomic_numbers == constants.SILICON
    ]
    if si_before.shape != (1, 2):
      counts['wrong_number_of_silicons'] += 1
      continue

    if grid_before.num_atoms < 10 or grid_after.num_atoms < 4:
      counts['wrong_number_of_neighbors'] += 1
      continue

    # 10 nearest (incl. self) in the before grid.
    d_before = np.linalg.norm(
        grid_before.atom_positions - si_before, axis=-1
    )
    order_before = np.argsort(d_before, kind='stable')[:10]
    neighbor_positions_before = grid_before.atom_positions[order_before]
    dist = d_before[order_before]

    # Coordination checks.
    is_fourfold = abs(dist[1] - dist[4]) < 0.5
    is_threefold = (dist[1:4] < 2.0).all() and (dist[4:] > 2.0).all()
    if is_fourfold:
      counts['fourfold'] += 1
      continue
    if not is_threefold:
      counts['not_threefold'] += 1
      continue
    neighbor_positions_before = neighbor_positions_before[:4]

    # 4 nearest (incl. site) in the after grid, around the OLD si position.
    d_after = np.linalg.norm(
        grid_after.atom_positions - si_before, axis=-1
    )
    order_after = np.argsort(d_after, kind='stable')[:4]
    neighbor_positions_after = grid_after.atom_positions[order_after]
    neighbor_numbers_after = grid_after.atomic_numbers[order_after]

    si_after = grid_after.atom_positions[
        grid_after.atomic_numbers == constants.SILICON
    ]
    if si_after.shape != (1, 2):
      counts['wrong_number_of_silicons'] += 1
      continue
    if not (neighbor_numbers_after == constants.SILICON).any():
      counts['no_silicon_neighbor'] += 1
      continue

    # Neighbor-set consistency across the pair.
    pair_dist = np.linalg.norm(
        neighbor_positions_before[:, None, :]
        - neighbor_positions_after[None, :, :],
        axis=-1,
    ).min(axis=-1)
    if pair_dist.mean() > neighbor_distance_cutoff:
      counts['neighbors_too_distant'] += 1
      continue

    # Canonical frame: rotate so the neighbor nearest the beam is on +x.
    control_delta = control.position - si_before.reshape(-1)
    neighbor_deltas = neighbor_positions_before - si_before
    beam_std, _, neighbor_order = data_utils.standardize_beam_and_neighbors(
        control_delta, neighbor_deltas[1:]
    )

    # Successor label: nearest before-neighbor slot to the after-silicon,
    # mapped through the canonical ordering.
    slot = int(
        np.argmin(
            np.linalg.norm(neighbor_positions_before - si_after, axis=-1)
        )
    )
    if slot > 0:
      next_state = int(np.argsort(neighbor_order)[slot - 1] + 1)
    else:
      next_state = 0

    data.append(
        DataPoint(
            next_state=next_state,
            beam_pos=beam_std.reshape(2),
            seconds_between=control.dwell_time.total_seconds(),
            current=control.current_na,
            voltage=control.voltage_kv,
        )
    )
    counts['kept'] += 1

  return data, counts


def stack_data(
    data: Sequence[DataPoint],
    use_current: bool = False,
    use_voltage: bool = False,
    dwell_time_in_context: bool = False,
    *,
    num_neighbors: int = 3,
) -> Dict[str, Optional[np.ndarray]]:
  """Stacks datapoints into a training dataset.

  Context column order is [current, voltage, (dwell)] — the same order the
  predictor prepends at inference (predictor.predict).
  """
  next_state = np.stack([d.next_state for d in data]).astype(np.int32)
  position = np.stack([d.beam_pos for d in data]).astype(np.float32)
  dt = np.stack([d.seconds_between for d in data]).astype(np.float32)
  rates = np.zeros((len(data), num_neighbors), np.float32)

  context_cols = []
  if use_current:
    context_cols.append(
        np.stack([d.current if d.current is not None else 0.0 for d in data])
    )
  if use_voltage:
    context_cols.append(
        np.stack([d.voltage if d.voltage is not None else 0.0 for d in data])
    )
  if dwell_time_in_context:
    context_cols.append(dt)
  context = (
      np.stack(context_cols, axis=-1).astype(np.float32)
      if context_cols
      else np.zeros((len(data), 0), np.float32)
  )
  return {
      'next_state': next_state,
      'dt': dt,
      'position': position,
      'rates': rates,
      'context': context,
  }


def load_trajectories_from_records(path: str) -> List[md.Trajectory]:
  """Loads trajectories from one records file or a directory of them."""
  if os.path.isdir(path):
    paths = [os.path.join(path, p) for p in sorted(os.listdir(path))]
  else:
    paths = [path]
  out = []
  for p in paths:
    out.extend(records.read_records(p, md.Trajectory))
  return out


def check_args(args: Args) -> LearnerType:
  """The learner type; raises NotImplementedError for what the port does
  not have, before any data is read."""
  learner_type = LearnerType(args.learner_type)
  if learner_type not in _NETWORK_TYPES:
    raise NotImplementedError(
        f'learner_type={args.learner_type!r}: the sklearn learners are not '
        'ported (ROADMAP queue 1, IO: the five sklearn learner types); use '
        "'rate_network' or 'classification_network'.")
  return learner_type


def main(args: Args):
  """Trains, distills and saves a rate predictor into args.workdir;
  returns (stacked data, drop-reason counts, the predictor)."""
  learner_type = check_args(args)
  os.makedirs(args.workdir, exist_ok=True)
  trajectories = load_trajectories_from_records(args.source_path)
  transitions = t2t.trajectories_to_transitions(
      trajectories, previous_controls_at_current_timestep=(
          args.previous_controls_at_current_timestep))
  datapoints, counts = transitions_to_datapoints(
      transitions, neighbor_distance_cutoff=args.neighbor_distance_cutoff)
  print('Transition filter counts:', counts, flush=True)
  if counts['no_controls'] and not args.previous_controls_at_current_timestep:
    # One dropped transition per trajectory is the signature of a logger
    # that attaches each control to the post-exposure observation, read
    # with the default convention: every remaining transition would then
    # pair with the previous step's beam position.
    print(f'Hint: {counts["no_controls"]} transitions had no controls. If '
          'your trajectories attach controls to the post-exposure '
          'observation, pass --previous_controls_at_current_timestep '
          "(otherwise each datapoint trains on the prior step's beam).",
          flush=True)

  stacked = stack_data(
      datapoints, use_current=args.use_current, use_voltage=args.use_voltage,
      dwell_time_in_context=learner_type != LearnerType.RATE_NETWORK)
  if learner_type != LearnerType.RATE_NETWORK:
    # Constant dt turns the survival model into plain classification.
    stacked['dt'] = np.ones_like(stacked['dt'])

  config = config_lib.RateLearningConfig(
      beam_units='angstroms',  # the pipeline canonicalises raw angstroms
      batch_size=args.batch_size,
      epochs=args.epochs,
      num_models=args.num_models,
      bootstrap=args.bootstrap,
      hidden_dimensions=tuple(args.hidden_dimensions),
      weight_decay=args.weight_decay,
      learning_rate=args.learning_rate,
      val_frac=args.val_frac,
      use_voltage=args.use_voltage,
      use_current=args.use_current,
      class_loss_weight=args.class_loss_weight,
      rate_loss_weight=args.rate_loss_weight,
      augment_data=args.augment_data,
      batchnorm=args.batchnorm,
      dropout_rate=args.dropout_rate,
  )
  predictor = predictor_lib.LearnedRatePredictor(
      config=config, device=args.device, seed=args.seed)

  def progress(done_epochs, last_metrics):
    print(f'epoch {done_epochs}/{config.epochs}: '
          + ' '.join(f'{k}={v:.4f}' for k, v in sorted(last_metrics.items())),
          flush=True)

  metrics = predictor.train(stacked, bootstrap=args.bootstrap,
                            epoch_chunk=args.epoch_chunk, progress=progress)
  if args.log_metrics:
    np.savez_compressed(os.path.join(args.workdir, 'metrics.npz'),
                        **{k: np.asarray(v) for k, v in metrics.items()})
  if args.plot_metrics:
    plotting_utils.plot_metrics(metrics, args.workdir)
  if args.distill:
    dev = predictor.device
    augmented = data_utils.augment_data(
        next_state=torch.as_tensor(stacked['next_state'], device=dev),
        dt=torch.as_tensor(stacked['dt'], device=dev),
        rates=torch.as_tensor(stacked['rates'], device=dev),
        position=torch.as_tensor(stacked['position'], device=dev),
        context=torch.as_tensor(stacked['context'], device=dev))
    predictor.distill(augmented)
  predictor.save(args.workdir)
  if args.visualize_rates and datapoints:
    context = stacked['context']
    plotting_utils.visualize_rates(
        os.path.join(args.workdir, 'avg_context_rates.png'),
        lambda x: predictor.apply_model(x).cpu().numpy(), grid_range=10.0,
        num_points=300**2,
        fixed_context=np.median(context, axis=0) if context.size else None)
  return stacked, counts, predictor


def _parse_args(argv: Optional[Sequence[str]] = None) -> Args:
  parser = argparse.ArgumentParser(description=__doc__)
  for field in dataclasses.fields(Args):
    name = f'--{field.name}'
    if isinstance(field.default, bool):
      parser.add_argument(name, action=argparse.BooleanOptionalAction,
                          default=field.default)
      # The absl spelling (--noplot_metrics) as an alias of --no-plot_metrics.
      parser.add_argument(f'--no{field.name}', dest=field.name,
                          action='store_false', help=argparse.SUPPRESS)
    elif field.name == 'hidden_dimensions':
      parser.add_argument(name, type=int, nargs='+',
                          default=list(field.default))
    elif field.default is dataclasses.MISSING:
      parser.add_argument(name, required=True)
    elif field.default is None:
      parser.add_argument(name, default=None,
                          help="'cpu' or a CUDA device (default: CUDA)")
    else:
      parser.add_argument(name, type=type(field.default),
                          default=field.default)
  kwargs = vars(parser.parse_args(argv))
  kwargs['hidden_dimensions'] = tuple(kwargs['hidden_dimensions'])
  return Args(**kwargs)


def cli() -> None:
  """Console entry point."""
  main(_parse_args())


if __name__ == '__main__':
  cli()
