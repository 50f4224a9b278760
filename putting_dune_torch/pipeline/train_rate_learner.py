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
(--visualize_rates), drawn by plotting_utils without matplotlib.

The five classical learner types (--learner_type=sklearn_mlp, knn, gp,
random_forest or svm) fit the port's own classifiers
(`putting_dune_torch/classifiers/`, float64 on the device) with the JAX
CLI's hyperparameters: a bootstrap ensemble of --num_models standardised
classifiers on the context columns and the beam position, each scored on
its out-of-bag rows, written as `{type}_{i}.joblib` and the soft
`{type}_ensemble.joblib`, the files the JAX CLI's `joblib.dump` writes
(`classifiers.joblib_io.dump`: sklearn's `joblib.load` reads them),
`metrics.npz` with `train_accuracy` / `test_accuracy`, and the
averaged `predict_proba[..., 1:]` as the rates of `avg_context_rates.png`.
The models that draw (MLP, forest, SVC) are seeded from --seed, one
`RandomState(seed).randint(2**31 - 1)` a model.
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
from putting_dune_torch.classifiers import ensemble as ensemble_lib
from putting_dune_torch.classifiers import gaussian_process
from putting_dune_torch.classifiers import joblib_io
from putting_dune_torch.classifiers import neighbors
from putting_dune_torch.classifiers import neural_network
from putting_dune_torch.classifiers import preprocessing
from putting_dune_torch.classifiers import svm
from putting_dune_torch.rate_learning import config as config_lib
from putting_dune_torch.rate_learning import data_utils
from putting_dune_torch.rate_learning import predictor as predictor_lib
from putting_dune_torch.rate_learning import train as train_lib


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
# The classical learners that draw random numbers, and so take a seed.
_SEEDED_TYPES = (LearnerType.SKLEARN_MLP, LearnerType.RANDOM_FOREST,
                 LearnerType.SVM)


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


# --- the classical learners ---------------------------------------------------


def get_sklearn_classifier(learner_type: str, args: Args,
                           standardize: bool = True, **kwargs):
  """The port's classifier for a classical learner type, with the JAX
  CLI's hyperparameters, on args.device unless kwargs give a device."""
  device = kwargs.pop('device', args.device)
  lt = LearnerType(learner_type)
  if lt == LearnerType.SKLEARN_MLP:
    model = neural_network.MLPClassifier(
        alpha=args.weight_decay, max_iter=args.epochs, device=device,
        **kwargs)
  elif lt == LearnerType.KNN:
    model = neighbors.KNeighborsClassifier(25, device=device, **kwargs)
  elif lt == LearnerType.GP:
    model = gaussian_process.GaussianProcessClassifier(device=device,
                                                       **kwargs)
  elif lt == LearnerType.RANDOM_FOREST:
    model = ensemble_lib.RandomForestClassifier(
        max_depth=5, n_estimators=10, device=device, **kwargs)
  elif lt == LearnerType.SVM:
    model = svm.SVC(gamma=2, C=1, probability=True, device=device, **kwargs)
  else:
    raise ValueError(f'Invalid learner type {learner_type}.')
  if standardize:
    model = preprocessing.make_pipeline(
        preprocessing.StandardScaler(device=device), model)
  return model


def train_sklearn_classifier(model, training_data, testing_data):
  """Fits on the context columns and scores both sets (accuracy)."""
  model.fit(training_data['context'], training_data['next_state'])
  train_acc = model.score(training_data['context'],
                          training_data['next_state'])
  test_acc = model.score(testing_data['context'], testing_data['next_state'])
  return model, train_acc, test_acc


def _classical(args: Args, learner_type: LearnerType, stacked):
  """The bootstrap ensemble of classical classifiers; returns (models,
  rate function)."""
  train_sets, test_sets = train_lib.create_dataset_splits(
      stacked, num_splits=args.num_models, seed=args.seed,
      bootstrap=args.bootstrap, augment=args.augment_data,
      test_fraction=args.val_frac)
  seeds = np.random.RandomState(args.seed).randint(
      np.iinfo(np.int32).max, size=args.num_models)
  models, train_accs, test_accs = [], [], []
  for i in range(args.num_models):
    train_data = {k: v[i] for k, v in train_sets.items()}
    test_data = {k: v[i] for k, v in test_sets.items()}
    kwargs = ({'random_state': int(seeds[i])}
              if learner_type in _SEEDED_TYPES else {})
    model = get_sklearn_classifier(args.learner_type, args, **kwargs)
    model, train_acc, test_acc = train_sklearn_classifier(
        model, train_data, test_data)
    print(f'{args.learner_type} {i}: train accuracy {train_acc:.4f}, test '
          f'accuracy {test_acc:.4f} ({len(train_data["next_state"])} rows; '
          f'fitted tensors on {model.step_estimators[0].mean_.device})',
          flush=True)
    joblib_io.dump(model, os.path.join(
        args.workdir, f'{args.learner_type}_{i}{joblib_io.SUFFIX}'))
    models.append(model)
    train_accs.append(train_acc)
    test_accs.append(test_acc)
  joblib_io.dump(
      ensemble_lib.VotingClassifier(
          [(f'{args.learner_type}_{i}', m) for i, m in enumerate(models)]),
      os.path.join(args.workdir,
                   f'{args.learner_type}_ensemble{joblib_io.SUFFIX}'))
  if args.log_metrics:
    np.savez_compressed(os.path.join(args.workdir, 'metrics.npz'),
                        train_accuracy=np.asarray(train_accs),
                        test_accuracy=np.asarray(test_accs))
  num_classes = int(stacked['next_state'].max()) + 1 if len(
      stacked['next_state']) else 1

  def rate_fn(x):
    """The models' mean of P(next state = k), k >= 1. A model whose
    bootstrap missed a class gives it probability 0 (the JAX CLI's mean
    needs every model to have every class)."""
    total = np.zeros((len(x), num_classes))
    for m in models:
      total[:, m.classes_] += m.predict_proba(x)
    return total[:, 1:] / len(models)

  return models, rate_fn


def main(args: Args):
  """Trains into args.workdir. For the networks: trains, distills and
  saves a rate predictor; returns (stacked data, drop-reason counts, the
  predictor). For the classical types: the bootstrap ensemble and its
  files; returns (stacked data, drop-reason counts, the fitted models)."""
  learner_type = LearnerType(args.learner_type)
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

  if learner_type not in _NETWORK_TYPES:
    models, rate_fn = _classical(args, learner_type, stacked)
    _visualize(args, stacked, datapoints, rate_fn)
    return stacked, counts, models

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
  _visualize(args, stacked, datapoints,
             lambda x: predictor.apply_model(x).cpu().numpy())
  return stacked, counts, predictor


def _visualize(args: Args, stacked, datapoints, rate_fn) -> None:
  """avg_context_rates.png: rate_fn over a 300^2 grid of beams at the
  median context (--visualize_rates)."""
  if args.visualize_rates and datapoints:
    context = stacked['context']
    plotting_utils.visualize_rates(
        os.path.join(args.workdir, 'avg_context_rates.png'), rate_fn,
        grid_range=10.0, num_points=300**2,
        fixed_context=np.median(context, axis=0) if context.size else None)


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
