"""The bars of `chip_smoke.py` phase 23a: the JAX package's test accuracy
of each classical learner type on a CPU recording made as phase 21 makes
its recording on the card.

  python scripts/classical_bars.py [--num_models=2] [--workdir=runs/bars]
      [--learners=knn,sklearn_mlp,gp,random_forest,svm]

It records the phase 19c rehearsal with the port on the CPU
(`greedy_on_neighbor`, 0.5 A of drift a frame, 128^2 renders, 32 episodes
of 35 steps, seeds 0-31, the agent's generator seeded 21), aligns it with
the port's align CLI (`--device=cpu`, the shipped aligner), then runs the
JAX package's `train_rate_learner.main` for each type at the CLI's
defaults (augmentation and bootstrap on, seed 42; --num_models cut as in
phase 23a; --previous_controls_at_current_timestep as phase 21; without
the rates plot) and prints, a type a line, the models' mean test
accuracy, the out-of-bag rows it averages over, the binomial standard
error sqrt(p (1 - p) / n) and the bar, the accuracy less three standard
errors. n counts out-of-bag transitions, not rows: the six rows the
augmentation makes of a transition (two reflections times three
rotations) are not independent draws. The recording and the aligned file
are kept in --workdir, so a rerun with other learners reuses them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EPISODES = 32
STEPS = 35
LEARNERS = ('knn', 'sklearn_mlp', 'gp', 'random_forest', 'svm')
AUGMENTATION = 6  # rows a transition: 2 reflections x 3 rotations


def record(workdir: str) -> str:
  """Phase 21a's recording on the CPU; returns the aligned file."""
  from putting_dune_torch import microscope_agent
  from putting_dune_torch import registry

  aligned = os.path.join(workdir, 'aligned.riegeli')
  if os.path.exists(aligned):
    return aligned
  logdir = os.path.join(workdir, 'logs')
  t0 = time.perf_counter()
  experiment = registry.create_microscope_experiment('greedy_on_neighbor')
  logger = microscope_agent.MicroscopeAgentLogger(
      microscope_agent.MicroscopeAgent(np.random.default_rng(21), experiment,
                                       device='cpu'), logdir=logdir)
  for seed in range(EPISODES):
    mic = microscope_agent.SimulatedMicroscope(
        seed=seed, drift_per_frame_angstroms=0.5, image_size=128,
        device='cpu')
    microscope_agent.rehearse(mic, logger, np.random.default_rng(seed), None,
                              steps=STEPS)
  logger.flush()
  print(f'recorded {EPISODES} x {STEPS} steps in '
        f'{time.perf_counter() - t0:.1f} s', flush=True)
  from putting_dune_torch.image_alignment import inference

  t0 = time.perf_counter()
  subprocess.run(
      [sys.executable, '-m', 'putting_dune_torch.pipeline.align_trajectories',
       f'--source_path={os.path.join(logdir, "trajectories.tfrecords")}',
       f'--target_path={aligned}',
       f'--aligner_workdir={inference.SHIPPED_ALIGNER_DIR}', '--device=cpu'],
      check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
  print(f'aligned in {time.perf_counter() - t0:.1f} s', flush=True)
  return aligned


def bar(learner: str, aligned: str, workdir: str, num_models: int) -> dict:
  from putting_dune_tpu.pipeline import train_rate_learner as j_trl

  out = os.path.join(workdir, learner)
  t0 = time.perf_counter()
  j_trl.main(j_trl.Args(
      source_path=aligned, workdir=out, learner_type=learner,
      num_models=num_models, visualize_rates=False, plot_metrics=False,
      previous_controls_at_current_timestep=True))
  seconds = time.perf_counter() - t0
  metrics = np.load(os.path.join(out, 'metrics.npz'))
  from putting_dune_tpu.pipeline import trajectories_to_transitions as t2t
  from putting_dune_tpu.rate_learning import train as j_train

  trajectories = j_trl.load_trajectories_from_records(aligned)
  transitions = t2t.trajectories_to_transitions(
      trajectories, previous_controls_at_current_timestep=True)
  datapoints, _ = j_trl.transitions_to_datapoints(transitions)
  stacked = j_trl.stack_data(datapoints, use_current=True, use_voltage=True,
                             dwell_time_in_context=True)
  _, test = j_train.create_dataset_splits(stacked, num_splits=num_models,
                                          seed=42, test_fraction=0.0)
  rows = int(np.asarray(test['next_state']).size)
  test_transitions = rows // AUGMENTATION
  acc = float(np.mean(metrics['test_accuracy']))
  se = float(np.sqrt(acc * (1 - acc) / test_transitions))
  return dict(learner=learner, num_models=num_models,
              train_accuracy=float(np.mean(metrics['train_accuracy'])),
              test_accuracy=acc, test_rows=rows,
              test_transitions=test_transitions, se=se, bar=acc - 3 * se,
              datapoints=len(datapoints), seconds=seconds)


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--num_models', type=int, default=2)
  parser.add_argument('--workdir', default=os.path.join(REPO, 'runs', 'bars'))
  parser.add_argument('--learners', default=','.join(LEARNERS))
  args = parser.parse_args()
  os.makedirs(args.workdir, exist_ok=True)
  aligned = record(args.workdir)
  for learner in args.learners.split(','):
    row = bar(learner, aligned, args.workdir, args.num_models)
    print(json.dumps(row), flush=True)


if __name__ == '__main__':
  main()
