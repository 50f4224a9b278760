"""Where the rate learner's time goes: the trainer and the distiller on one GPU.

  python scripts/profile_rate_learner.py [--num_data=40960] [--epochs=2]
      [--distill_epochs=5]

Trains the bootstrap ensemble at the shipped predictor's widths (its
config.json: 50 models, hidden (128, 128), batch 256, batch norm, AdamW
with weight decay 0.1) on `--num_data` synthetic prior transitions made on
the card (x6 augmented, bootstrapped), then distills it at `DistillConfig`'s
batch 4096:

  1. plain: host wall clock per epoch (synchronized) after a warm-up
     epoch, ms per step and steps per second, and the 500-epoch projection;
  2. torch.profiler over one epoch: device busy share (summed kernel time
     / wall time), kernel launches per step and the largest kernels;
  3. the same two readings for distillation steps at batch 4096.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _profile(fn, steps, dev):
  import torch
  from torch.profiler import ProfilerActivity, profile

  activities = [ProfilerActivity.CPU]
  if dev.type == 'cuda':
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities) as prof:
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  overhead = ('Command Buffer Full', 'Buffer Flush',
              'Activity Buffer Request')
  kernels = [e for e in prof.key_averages()
             if getattr(e, 'device_time_total', 0) > 0 and e.key
             and not e.key.startswith('aten::')
             and not e.key.startswith('cuda') and e.key not in overhead]
  busy = sum(e.self_device_time_total for e in kernels) / 1e6
  launches = sum(e.count for e in kernels)
  print(f'  profiler: wall {wall / steps * 1e3:.4f} ms per step, device '
        f'busy {busy / steps * 1e3:.4f} ms per step, busy share '
        f'{busy / wall:.3f}, {launches / steps:.1f} kernel launches per '
        f'step', flush=True)
  kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
  for e in kernels[:12]:
    print(f'  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step '
          f'{e.count / steps:6.1f} calls/step  {e.key[:90]}', flush=True)


def main(argv=None) -> None:
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, root)
  import torch

  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.rate_learning import config as rl_config
  from putting_dune_torch.rate_learning import data_utils
  from putting_dune_torch.rate_learning import distill
  from putting_dune_torch.rate_learning import model as model_lib
  from putting_dune_torch.rate_learning import train
  from putting_dune_torch.utils import training as training_utils

  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--num_data', type=int, default=40_960)
  parser.add_argument('--epochs', type=int, default=2)
  parser.add_argument('--distill_epochs', type=int, default=5)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  dev = torch.device(args.device)

  def sync():
    if dev.type == 'cuda':
      torch.cuda.synchronize()

  shipped = os.path.join(eval_agent.MODEL_WEIGHTS_DIR, 'rate_predictor')
  with open(os.path.join(shipped, 'config.json')) as f:
    stored = json.load(f)
  stored.pop('num_models_current')
  stored['hidden_dimensions'] = tuple(stored['hidden_dimensions'])
  config = dataclasses.replace(rl_config.RateLearningConfig(**stored),
                               beam_units='bonds')
  gen = torch.Generator(device=dev).manual_seed(0)
  data, _ = data_utils.generate_synthetic_data(
      num_data=args.num_data, generator=gen, device=dev)
  host = {k: v.cpu().numpy() for k, v in data.items()}
  t0 = time.perf_counter()
  train_sets, _ = train.create_dataset_splits(host, config.num_models,
                                              seed=0)
  splits_s = time.perf_counter() - t0
  train_data = train.to_device(train_sets, dev)
  num_models, rows = train_data['next_state'].shape
  steps = rows // config.batch_size
  model = model_lib.RateMLP(num_models, train_data['context'].shape[-1],
                            config.hidden_dimensions, config.num_states,
                            config.batchnorm, device=dev, generator=gen)
  optimizer = training_utils.adamw(model, config.learning_rate,
                                  config.weight_decay)

  def epoch():
    train.train_epoch(model, optimizer, config.batch_size, gen, train_data,
                      config)

  print(f'trainer: {num_models} models, hidden {config.hidden_dimensions}, '
        f'batch {config.batch_size}, {args.num_data} transitions -> {rows} '
        f'rows per model, {steps} steps an epoch; host splits '
        f'{splits_s:.2f} s', flush=True)
  epoch()  # warm-up
  sync()
  times = []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    epoch()
    sync()
    times.append(time.perf_counter() - t0)
  per_epoch = sum(times) / len(times)
  print(f'  plain: epochs {", ".join(f"{t:.3f}" for t in times)} s, '
        f'{per_epoch / steps * 1e3:.4f} ms per step, '
        f'{steps / per_epoch:.1f} steps/s; 500 epochs projected '
        f'{500 * per_epoch:.1f} s', flush=True)
  _profile(epoch, steps, dev)

  distill_config = rl_config.DistillConfig()
  teacher = model.eval()
  student = model_lib.RateMLP(1, model.in_features, config.hidden_dimensions,
                              config.num_states, config.batchnorm,
                              device=dev, generator=gen)
  opt = training_utils.adamw(student, config.learning_rate,
                            config.weight_decay)
  x = torch.cat([data['context'], data['position']], -1)
  mean, scale = x.mean(0), x.std(0)
  batches = distill_config.batches_per_epoch

  def distill_epochs():
    for _ in range(args.distill_epochs):
      distill.distill_train_epoch(student, teacher, opt, gen, batches,
                                  distill_config.batch_size, mean, scale)

  distill_epochs()  # warm-up
  sync()
  t0 = time.perf_counter()
  distill_epochs()
  sync()
  dsteps = args.distill_epochs * batches
  per = (time.perf_counter() - t0) / dsteps
  print(f'distillation: batch {distill_config.batch_size}, teacher '
        f'{num_models} models: {per * 1e3:.4f} ms per step, '
        f'{1 / per:.1f} steps/s; {distill_config.epochs} epochs x '
        f'{batches} batches projected '
        f'{per * distill_config.epochs * batches:.1f} s', flush=True)
  _profile(distill_epochs, dsteps, dev)


if __name__ == '__main__':
  main()
