"""The perception trainers' recipes in one package on the CPU: the numbers
that set `chip_smoke.py` phase 20's bars.

  python scripts/perception_bars.py --package=jax|torch [--batch=8] \
      [--eval_batches=4] [--seed=13] [--out=runs/perception_bars/jax.json]

Each recipe is the shipped one with only its batch (and the step counts of
phase 20) cut:

  * detector: the noise-robust fine-tune of the shipped `atom_detector`
    (runs/train_detector_noiserobust.py: 256^2, noisy eval, noisy_fraction
    0.4, class weights (0.2, 1, 10), lr 1e-4, seed 13), 2 epochs x 8 steps,
    4 eval steps; the pixel accuracy of the shipped and of the fine-tuned
    model on `--eval_batches` fixed noisy batches (a seed of their own);
  * image aligner: the registration fine-tune of the shipped
    `image_aligner` (runs/train_perception2.py: 128^2, 5 frames,
    registration_noise 0.35, inference_preprocessing, seed_fraction 0.25,
    lr 1e-3), 1 epoch x 8 steps, 4 eval steps; the drift error before and
    after on fixed eval stacks;
  * graph aligner: the shipped `graph_aligner` params (the Config defaults:
    width 64, 3 layers, k 8, capacity 256, 2 frames) against the zero
    predictor on fixed eval batches of 16.

The two packages draw different streams (threefry against Philox), so
their numbers agree in law only. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, 'putting_dune_tpu', 'experiments',
                       'model_weights')
EVAL_SEED = 1000


def detector_config(lib, workdir, batch, seed):
  return lib.Config(
      workdir=workdir, image_size=256, batch_size=batch, epochs=2,
      steps_per_epoch=8, eval_steps=4, noisy_images=True, noisy_fraction=0.4,
      class_weights=(0.2, 1.0, 10.0), learning_rate=1e-4,
      features=(64, 128, 256, 512, 1024),
      init_params_from=os.path.join(WEIGHTS, 'atom_detector'), seed=seed)


def aligner_config(lib, workdir, batch, seed):
  return lib.Config(
      workdir=workdir, image_size=128, batch_size=batch, epochs=1,
      steps_per_epoch=8, eval_steps=4, num_frames=5,
      features=(64, 128, 256, 512), registration_noise=0.35,
      inference_preprocessing=True, seed_fraction=0.25,
      init_params_from=os.path.join(WEIGHTS, 'image_aligner'), seed=seed)


def _jax(args):
  import numpy as np

  from putting_dune_tpu.atom_detection import data as det_data
  from putting_dune_tpu.atom_detection import train as det_train
  from putting_dune_tpu.graph_alignment import data as graph_data
  from putting_dune_tpu.graph_alignment import model as graph_model
  from putting_dune_tpu.graph_alignment import train as graph_train
  from putting_dune_tpu.image_alignment import data as align_data
  from putting_dune_tpu.image_alignment import train as align_train

  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    config = detector_config(det_train, tmp, args.batch, args.seed)
    shipped = det_train.create_state(config).replace(
        params=det_train.load_params(config.init_params_from, config))
    evals = det_data.dataset_iterator(EVAL_SEED, batch_size=args.batch,
                                      image_size=256, noisy=True)
    batches = [next(evals) for _ in range(args.eval_batches)]
    acc = lambda s: float(np.mean([det_train.eval_step(s, b)  # noqa: E731
                                   for b in batches]))
    out['detector_shipped_accuracy'] = acc(shipped)
    t0 = time.perf_counter()
    history = []
    state = det_train.train(config, progress=lambda e, m: history.append(m))
    out['detector_seconds'] = time.perf_counter() - t0
    out['detector_history'] = history
    out['detector_trained_accuracy'] = acc(state)

  with tempfile.TemporaryDirectory() as tmp:
    config = aligner_config(align_train, tmp, args.batch, args.seed)
    shipped = align_train.create_state(config).replace(
        params=align_train.load_params(config.init_params_from))
    evals = align_data.dataset_iterator(
        EVAL_SEED, batch_size=args.batch, image_size=128, num_frames=5,
        registration_noise=0.35, inference_preprocessing=True,
        seed_fraction=0.25)
    batches = [next(evals) for _ in range(args.eval_batches)]
    err = lambda s: float(np.mean([align_train.eval_step(  # noqa: E731
        s, b, 5, False)['drift_error'] for b in batches]))
    out['aligner_shipped_drift_error'] = err(shipped)
    history = []
    state = align_train.train(config, progress=lambda e, m: history.append(m))
    out['aligner_history'] = history
    out['aligner_trained_drift_error'] = err(state)

  config = graph_train.Config(workdir='')
  params = graph_train.load_params(os.path.join(WEIGHTS, 'graph_aligner'),
                                   config)
  module = graph_model.AlignmentGraphNetwork()
  evals = graph_data.dataset_iterator(EVAL_SEED, batch_size=16)
  shipped, zero = [], []
  for _ in range(args.eval_batches):
    batch = next(evals)
    g, _ = graph_model.batched_apply(module, params, batch)
    shipped.append(float(np.mean(np.linalg.norm(
        np.asarray(g) - np.asarray(batch['drift']), axis=-1))))
    zero.append(float(np.mean(np.linalg.norm(np.asarray(batch['drift']),
                                             axis=-1))))
  out['graph_shipped_drift_error'] = float(np.mean(shipped))
  out['graph_zero_drift_error'] = float(np.mean(zero))
  return out


def _torch(args):
  import numpy as np
  import torch

  from putting_dune_torch.atom_detection import data as det_data
  from putting_dune_torch.atom_detection import model as det_model
  from putting_dune_torch.atom_detection import train as det_train
  from putting_dune_torch.graph_alignment import data as graph_data
  from putting_dune_torch.graph_alignment import model as graph_model
  from putting_dune_torch.image_alignment import data as align_data
  from putting_dune_torch.image_alignment import model as align_model
  from putting_dune_torch.image_alignment import train as align_train
  from putting_dune_torch.io import serialization

  dev = args.device
  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    config = detector_config(det_train, tmp, args.batch, args.seed)
    shipped = det_train.create_state(config, dev)
    shipped.model.load_state_dict(det_model.params_from_flax(
        det_train.load_params(config.init_params_from)))
    evals = det_data.dataset_iterator(EVAL_SEED, batch_size=args.batch,
                                      image_size=256, noisy=True, device=dev)
    batches = [next(evals) for _ in range(args.eval_batches)]
    acc = lambda s: float(np.mean([float(det_train.eval_step(s, b))  # noqa: E731
                                   for b in batches]))
    out['detector_shipped_accuracy'] = acc(shipped)
    t0 = time.perf_counter()
    history = []
    state = det_train.train(config, device=dev,
                            progress=lambda e, m: history.append(m))
    out['detector_seconds'] = time.perf_counter() - t0
    out['detector_history'] = history
    out['detector_trained_accuracy'] = acc(state)

  with tempfile.TemporaryDirectory() as tmp:
    config = aligner_config(align_train, tmp, args.batch, args.seed)
    shipped = align_train.create_state(config, dev)
    shipped.model.load_state_dict(align_model.params_from_flax(
        align_train.load_params(config.init_params_from)))
    evals = align_data.dataset_iterator(
        EVAL_SEED, batch_size=args.batch, image_size=128, num_frames=5,
        registration_noise=0.35, inference_preprocessing=True,
        seed_fraction=0.25, device=dev)
    batches = [next(evals) for _ in range(args.eval_batches)]
    err = lambda s: float(np.mean([float(align_train.eval_step(  # noqa: E731
        s, b, 5, False)['drift_error']) for b in batches]))
    out['aligner_shipped_drift_error'] = err(shipped)
    history = []
    state = align_train.train(config, device=dev,
                              progress=lambda e, m: history.append(m))
    out['aligner_history'] = history
    out['aligner_trained_drift_error'] = err(state)

  model = graph_model.from_flax(
      serialization.read_params_msgpack(graph_model.SHIPPED_DIR)).to(dev)
  evals = graph_data.dataset_iterator(EVAL_SEED, batch_size=16, device=dev)
  shipped, zero = [], []
  with torch.no_grad():
    for _ in range(args.eval_batches):
      batch = next(evals)
      g, _ = graph_model.batched_apply(model, batch)
      shipped.append(float(torch.linalg.vector_norm(
          g - batch['drift'], dim=-1).mean()))
      zero.append(float(torch.linalg.vector_norm(batch['drift'],
                                                 dim=-1).mean()))
  out['graph_shipped_drift_error'] = float(np.mean(shipped))
  out['graph_zero_drift_error'] = float(np.mean(zero))
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--package', choices=('jax', 'torch'), required=True)
  parser.add_argument('--batch', type=int, default=8)
  parser.add_argument('--eval_batches', type=int, default=4)
  parser.add_argument('--seed', type=int, default=13)
  parser.add_argument('--device', default='cpu')
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  sys.path.insert(0, ROOT)
  if args.package == 'torch':
    import torch

    torch.set_num_threads(4)
  out = {'package': args.package, 'batch': args.batch, 'seed': args.seed,
         **(_jax(args) if args.package == 'jax' else _torch(args))}
  text = json.dumps(out)
  print(text, flush=True)
  if args.out:
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
      f.write(text)


if __name__ == '__main__':
  main()
