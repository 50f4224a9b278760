"""Writes the fixtures that the port's readers are held to on the card,
where sklearn, joblib and cv2 are not installed.

  python scripts/make_classifier_fixtures.py [--out_dir=tests/data]

`torch_classifiers/`: a recording made with the JAX simulator (3
trajectories of 40 steps on a 20-column lattice, the JAX pipeline's
filter, its classical stacking with the dwell column, one augmented
bootstrap draw), of which the first 200 rows (100 for the Gaussian
process, whose file holds an n x n Cholesky factor a class) fit each
learner type of the JAX CLI's `get_sklearn_classifier`, dumped with
joblib as `{type}.joblib`; `ensemble.joblib`, the CLI's soft
VotingClassifier over two forests; `queries.npy`, a 24 x 24 grid of beam
positions at the median context and 64 recorded rows; and
`{type}_proba.npy` / `ensemble_proba.npy`, sklearn's `predict_proba` on
them. `versions.json` records the library versions.

`torch_jpeg/`: eight small JPEGs of seeded smooth images (cv2 and PIL
encoders: grey, 4:4:4, 4:2:2, 4:2:0, 4:4:0, progressive, a restart
interval, odd sizes) and `cv2.imdecode(..., IMREAD_UNCHANGED)` of each
as `.npy`.
"""

from __future__ import annotations

import argparse
import datetime as dt
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LEARNERS = ('sklearn_mlp', 'knn', 'gp', 'random_forest', 'svm')


def _trajectory(seed: int, num_steps: int = 40):
  """One JAX-simulator trajectory with small images (the JAX package's
  pipeline tests' recipe)."""
  import jax
  import jax.numpy as jnp

  from putting_dune_tpu import lattice as j_lattice
  from putting_dune_tpu import microscope_data as j_md
  from putting_dune_tpu import rates as j_rates
  from putting_dune_tpu import simulator as j_simulator
  from putting_dune_tpu import structures as j_structures

  lattice = j_lattice.make_lattice(num_cols=20)
  config = j_simulator.SimulatorConfig(grid_columns=20)
  rng = np.random.default_rng(seed)
  key = jax.random.PRNGKey(seed)
  state, obs = j_simulator.reset(key, lattice, config=config, batch_size=1,
                                 return_window=True)
  images = rng.random((num_steps + 1, 8, 8)).astype(np.float32)
  observations = [j_md.observation_from_device(
      obs.window, obs.fov, obs.elapsed_seconds, image=images[:1])]
  for i in range(num_steps):
    key, k_ctrl, k_step = jax.random.split(key, 3)
    delta = jax.random.uniform(k_ctrl, (1, 2), minval=-0.1, maxval=0.1)
    control = j_structures.BeamControl(
        position=jnp.clip(obs.si_position_microscope + delta, 0.0, 1.0),
        dwell_seconds=jnp.full((1,), 5.0), voltage_kv=jnp.full((1,), 60.0),
        current_na=jnp.full((1,), 0.1))
    state, obs, _ = j_simulator.step(
        state, k_step, control, lattice, j_rates.simple_canonical_rates,
        config=config, return_window=True)
    host_controls = (j_md.BeamControl(
        np.asarray(control.position)[0], dt.timedelta(seconds=5.0),
        voltage_kv=60.0, current_na=0.1),)
    observations.append(j_md.observation_from_device(
        obs.window, obs.fov, obs.elapsed_seconds, controls=host_controls,
        image=images[i + 1:i + 2]))
  return j_md.Trajectory(tuple(observations))


def recorded_rows(rows: int = 200):
  """(context, next_state) rows as the JAX CLI's classical branch fits."""
  from putting_dune_tpu.pipeline import train_rate_learner as j_trl
  from putting_dune_tpu.pipeline import trajectories_to_transitions as t2t
  from putting_dune_tpu.rate_learning import train as j_train

  trajectories = [_trajectory(seed) for seed in range(3)]
  transitions = t2t.trajectories_to_transitions(
      trajectories, previous_controls_at_current_timestep=True)
  datapoints, _ = j_trl.transitions_to_datapoints(transitions)
  stacked = j_trl.stack_data(datapoints, use_current=True, use_voltage=True,
                             dwell_time_in_context=True)
  stacked['dt'] = np.ones_like(stacked['dt'])
  train, _ = j_train.create_dataset_splits(stacked, num_splits=1, seed=0)
  context = np.asarray(train['context'][0])[:rows]
  labels = np.asarray(train['next_state'][0])[:rows]
  return context, labels


def queries(context: np.ndarray) -> np.ndarray:
  side = np.linspace(-3.0, 3.0, 24)
  xx, yy = np.meshgrid(side, side)
  median = np.median(context[:, :-2], axis=0)
  grid = np.concatenate([np.broadcast_to(median, (xx.size, len(median))),
                         xx.reshape(-1, 1), yy.reshape(-1, 1)], axis=1)
  rng = np.random.default_rng(1)
  rows = context[rng.choice(len(context), 64, replace=False)].astype(
      np.float64)
  rows[:, -2:] += rng.normal(scale=0.05, size=(64, 2))
  return np.concatenate([grid, rows]).astype(np.float64)


def classifiers(out: str) -> None:
  import joblib
  import sklearn
  from sklearn import ensemble as skensemble

  from putting_dune_tpu.pipeline import train_rate_learner as j_trl

  os.makedirs(out, exist_ok=True)
  context, labels = recorded_rows()
  grid = queries(context)
  np.save(os.path.join(out, 'queries.npy'), grid)
  args = j_trl.Args(source_path='', workdir='')
  seeded = {'sklearn_mlp', 'random_forest', 'svm'}
  for lt in LEARNERS:
    rows = 100 if lt == 'gp' else len(labels)
    kwargs = {'random_state': 0} if lt in seeded else {}
    model = j_trl.get_sklearn_classifier(lt, args, **kwargs)
    model.fit(context[:rows], labels[:rows])
    joblib.dump(model, os.path.join(out, f'{lt}.joblib'))
    np.save(os.path.join(out, f'{lt}_proba.npy'), model.predict_proba(grid))
    print(f'{lt}: {rows} rows, train accuracy '
          f'{model.score(context[:rows], labels[:rows]):.4f}')
  forests = [j_trl.get_sklearn_classifier('random_forest', args,
                                          random_state=s).fit(context, labels)
             for s in (1, 2)]
  ens = skensemble.VotingClassifier(
      [(f'random_forest_{i}', m) for i, m in enumerate(forests)],
      voting='soft')
  ens.estimators_ = forests
  ens.le_ = None  # fitted estimators injected, as the JAX CLI does
  joblib.dump(ens, os.path.join(out, 'ensemble.joblib'))
  np.save(os.path.join(out, 'ensemble_proba.npy'), ens.predict_proba(grid))
  with open(os.path.join(out, 'versions.json'), 'w') as f:
    json.dump({'sklearn': sklearn.__version__, 'joblib': joblib.__version__,
               'numpy': np.__version__, 'rows': int(len(labels))}, f,
              indent=1)


def _smooth(rng, h, w, c):
  import cv2

  base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, c)).astype(np.uint8)
  img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
  img = img.reshape(h, w, c) if c > 1 else img.reshape(h, w)
  noise = rng.integers(-20, 20, img.shape)
  return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def jpegs(out: str) -> None:
  import cv2
  from PIL import Image

  os.makedirs(out, exist_ok=True)
  rng = np.random.default_rng(0)
  sf = lambda s: getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{s}')
  cases = {
      'grey_q75': ((37, 53, 1), [cv2.IMWRITE_JPEG_QUALITY, 75]),
      'ycc420_q10': ((33, 47, 3), [cv2.IMWRITE_JPEG_QUALITY, 10,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   sf('420')]),
      'ycc422_q95': ((29, 41, 3), [cv2.IMWRITE_JPEG_QUALITY, 95,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   sf('422')]),
      'ycc440_q75': ((31, 45, 3), [cv2.IMWRITE_JPEG_QUALITY, 75,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   sf('440')]),
      'ycc444_q75': ((24, 40, 3), [cv2.IMWRITE_JPEG_QUALITY, 75,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   sf('444')]),
      'progressive420_q75': ((35, 51, 3), [cv2.IMWRITE_JPEG_QUALITY, 75,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
      'restart420_q90': ((40, 48, 3), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                       cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
  }
  for name, ((h, w, c), params) in cases.items():
    ok, data = cv2.imencode('.jpg', _smooth(rng, h, w, c), params)
    assert ok
    _write_jpeg(out, name, data.tobytes())
  buf = io.BytesIO()
  Image.fromarray(_smooth(rng, 23, 37, 3)).save(
      buf, 'JPEG', quality=80, subsampling=1, progressive=True)
  _write_jpeg(out, 'pil_progressive422_q80', buf.getvalue())


def _write_jpeg(out: str, name: str, data: bytes) -> None:
  import cv2

  with open(os.path.join(out, f'{name}.jpg'), 'wb') as f:
    f.write(data)
  pixels = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
  np.save(os.path.join(out, f'{name}.npy'), pixels)
  print(f'{name}: {len(data)} bytes, {pixels.shape}')


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--out_dir', default=os.path.join(REPO, 'tests',
                                                        'data'))
  args = parser.parse_args()
  classifiers(os.path.join(args.out_dir, 'torch_classifiers'))
  jpegs(os.path.join(args.out_dir, 'torch_jpeg'))


if __name__ == '__main__':
  main()
