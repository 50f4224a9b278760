"""The hardware-loop rehearsal through both packages on the CPU, same seeds.

  python scripts/rehearsal_pair.py [--seeds=0-15] [--steps=35] \
      [--out_dir=runs/rehearsal_pair]

For each seed s: a `SimulatedMicroscope(seed=s)` drifting 0.5 A per frame
per axis and rendering 128^2 frames, a `MicroscopeAgent` on the
`greedy_on_neighbor` microscope experiment with `np.random.default_rng(s)`,
driven for `--steps` steps twice: with the shipped `ImageAligner`
correcting the FOV claims in the loop, and without it (the JAX package's
`test_hardware_loop_rehearsal_with_aligner_under_drift`, over many seeds).
Each package runs in a process of its own (`--worker=jax|torch`; JAX with
JAX_PLATFORMS=cpu), one after the other. The PRNG streams differ
(threefry against Philox), so a seed draws different episodes in the two.

With `--alignment`, each seed instead drives the JAX package's
`test_learned_aligner_recovers_simulated_drift`: 12 frames of a microscope
drifting 0.5 A per frame whose silicon does not move (tiny rates), aligned
by `do_alignment`; the parent prints, for each package, the mean over
seeds of the increment error and of the last three frames' error
corrected and uncorrected, and the share of seeds that meet each of that
test's bars (increment error < 0.35 A; last three < 0.8x uncorrected).

Otherwise it prints, for each package: the share of seeds on which the corrected loop
brought the true silicon within 0.72 A of the goal (the JAX test's bar),
with its binomial standard error, the same share for the uncorrected loop,
and the mean final distance of the corrected and of the uncorrected loop;
then the z of the share difference. Per-seed results go to `--out_dir` as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REACH_ANGSTROMS = 0.72
EXPERIMENT = 'greedy_on_neighbor'


def parse_seeds(text: str):
  if '-' in text:
    lo, hi = text.split('-')
    return tuple(range(int(lo), int(hi) + 1))
  return tuple(int(s) for s in text.split(','))


def _jax_run(seed, steps, aligner, correct):
  """One rehearsal in the JAX package, as its test drives it."""
  import numpy as np

  from putting_dune_tpu import microscope_agent as ma
  from putting_dune_tpu import microscope_data as md
  from putting_dune_tpu.experiments import registry

  mic = ma.SimulatedMicroscope(seed=seed, grid_columns=50,
                               drift_per_frame_angstroms=0.5, image_size=128)
  rng = np.random.default_rng(seed)
  agent = ma.MicroscopeAgent(
      rng, registry.create_microscope_experiment(EXPERIMENT))
  obs = mic.reset()
  agent.reset(rng, obs)
  goal = agent.goal.goal_position_material_frame.copy()
  cumulative = np.zeros(2)
  if correct:
    aligner.reset()
  closest = np.inf
  for _ in range(steps):
    if correct:
      _, new_shift, _ = aligner(obs.image, obs.fov.shift(-cumulative))
      cumulative = cumulative - new_shift
      fixed_fov = obs.fov.shift(-cumulative)
      aligner.amend_last_fov(fixed_fov)
      aligner.refine_history_claims()
      obs = md.MicroscopeObservation(
          grid=obs.grid, fov=fixed_fov, controls=obs.controls,
          elapsed_time=obs.elapsed_time)
    obs = mic.apply(agent.step(obs))
    closest = min(closest, float(np.linalg.norm(
        mic.true_silicon_position() - goal)))
  return closest, float(np.linalg.norm(mic.true_silicon_position() - goal))


def _torch_run(seed, steps, aligner, correct):
  import numpy as np

  from putting_dune_torch import microscope_agent as ma
  from putting_dune_torch import registry

  mic = ma.SimulatedMicroscope(seed=seed, grid_columns=50,
                               drift_per_frame_angstroms=0.5, image_size=128,
                               device='cpu')
  rng = np.random.default_rng(seed)
  agent = ma.MicroscopeAgent(
      rng, registry.create_microscope_experiment(EXPERIMENT), device='cpu')
  return ma.rehearse(mic, agent, rng, aligner if correct else None, steps)


def _alignment_errors(recovered, true_drift):
  import numpy as np

  inc = np.linalg.norm(np.diff(-recovered, axis=0)
                       - np.diff(true_drift, axis=0), axis=1)
  return {'inc_err': float(inc.mean()),
          'last3': float(np.linalg.norm(recovered + true_drift,
                                        axis=1)[-3:].mean()),
          'last3_uncorrected': float(np.linalg.norm(true_drift,
                                                    axis=1)[-3:].mean())}


def _jax_alignment(seed, aligner, frames=12):
  """The JAX test's sequence from its simulator, aligned by do_alignment."""
  import datetime as dt

  import jax
  import jax.numpy as jnp
  import numpy as np

  from putting_dune_tpu import lattice as lattice_lib
  from putting_dune_tpu import microscope_data as md
  from putting_dune_tpu import simulator as simulator_lib
  from putting_dune_tpu import structures
  from putting_dune_tpu.pipeline import align_trajectories as at

  lattice = lattice_lib.make_lattice(50)
  config = simulator_lib.SimulatorConfig(image_size=128,
                                         drift_per_frame_angstroms=0.5)
  key = jax.random.PRNGKey(seed)
  key, k = jax.random.split(key)
  state, obs = simulator_lib.reset(k, lattice, config=config, batch_size=1,
                                   return_image=True)

  def tiny_rates(si_pos, neighbor_pos, beam_pos):
    del neighbor_pos, beam_pos
    return jnp.full(si_pos.shape[:-1] + (3,), 1e-12)

  grid = md.AtomicGrid(np.zeros((1, 2)), np.asarray([6]))

  def observation(state, obs, t):
    return md.MicroscopeObservation(
        grid=grid, fov=md.MicroscopeFieldOfView(
            np.asarray(state.fov.lower_left)[0].copy(),
            np.asarray(state.fov.upper_right)[0].copy()),
        controls=(), elapsed_time=dt.timedelta(seconds=float(t)),
        image=np.asarray(obs.image)[0])

  observations, drifts = [observation(state, obs, 0)], [np.zeros(2)]
  for t in range(1, frames):
    key, k = jax.random.split(key)
    control = structures.BeamControl(position=jnp.full((1, 2), 0.5),
                                     dwell_seconds=jnp.full((1,), 1.5))
    state, obs, _ = simulator_lib.step(state, k, control, lattice,
                                       tiny_rates, config=config,
                                       return_image=True)
    observations.append(observation(state, obs, t))
    drifts.append(np.asarray(state.drift)[0].copy())
  aligned = at.do_alignment(
      md.Trajectory(tuple(observations)),
      at.Args(source_path='', target_path='', aligner_workdir=''), aligner)
  recovered = np.stack([a.fov.lower_left - o.fov.lower_left
                        for a, o in zip(aligned.observations, observations)])
  return _alignment_errors(recovered, np.stack(drifts))


def _torch_alignment(seed, aligner, frames=12):
  import numpy as np

  from putting_dune_torch import microscope_agent as ma
  from putting_dune_torch import microscope_data as md
  from putting_dune_torch.pipeline import align_trajectories as at

  observations, drifts = ma.drifting_sequence(seed, frames, device='cpu')
  aligned = at.do_alignment(
      md.Trajectory(tuple(observations)),
      at.Args(source_path='', target_path='', aligner_workdir=''), aligner)
  recovered = np.stack([a.fov.lower_left - o.fov.lower_left
                        for a, o in zip(aligned.observations, observations)])
  return _alignment_errors(recovered, drifts)


def worker(package, seeds, steps, out_path, alignment=False):
  sys.path.insert(0, ROOT)
  if package == 'jax':
    from putting_dune_tpu.experiments import registry
    from putting_dune_tpu.image_alignment import inference

    aligner = inference.ImageAligner.from_checkpoint(os.path.join(
        os.path.dirname(registry.__file__), 'model_weights', 'image_aligner'))
    run = _jax_alignment if alignment else _jax_run
  else:
    import torch

    from putting_dune_torch.image_alignment import inference

    torch.set_num_threads(4)
    aligner = inference.ImageAligner.from_checkpoint(device='cpu')
    run = _torch_alignment if alignment else _torch_run
  rows = []
  for seed in seeds:
    if alignment:
      rows.append({'seed': seed, **run(seed, aligner)})
      print(package, rows[-1], flush=True)
      continue
    t0 = time.perf_counter()
    closest, final = run(seed, steps, aligner, True)
    closest_off, final_off = run(seed, steps, aligner, False)
    rows.append({'seed': seed, 'closest': closest, 'final': final,
                 'closest_uncorrected': closest_off,
                 'final_uncorrected': final_off,
                 'seconds': time.perf_counter() - t0})
    print(package, rows[-1], flush=True)
  with open(out_path, 'w') as f:
    json.dump(rows, f)


def alignment_summary(rows):
  n = len(rows)
  mean = lambda key: sum(r[key] for r in rows) / n  # noqa: E731
  return {
      'seeds': n, 'inc_err': mean('inc_err'), 'last3': mean('last3'),
      'last3_uncorrected': mean('last3_uncorrected'),
      'share_inc_below_0.35': sum(r['inc_err'] < 0.35 for r in rows) / n,
      'share_last3_below_0.8x': sum(
          r['last3'] < 0.8 * r['last3_uncorrected'] for r in rows) / n,
  }


def summary(rows):
  n = len(rows)
  share = sum(r['closest'] < REACH_ANGSTROMS for r in rows) / n
  se = math.sqrt(max(share * (1 - share), 1e-12) / n)
  return {
      'seeds': n, 'reach_share': share, 'reach_se': se,
      'reach_share_uncorrected': sum(
          r['closest_uncorrected'] < REACH_ANGSTROMS for r in rows) / n,
      'mean_final_corrected': sum(r['final'] for r in rows) / n,
      'mean_final_uncorrected': sum(r['final_uncorrected'] for r in rows) / n,
  }


def main():
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--seeds', default='0-15')
  parser.add_argument('--steps', type=int, default=35)
  parser.add_argument('--out_dir', default=os.path.join(
      ROOT, 'runs', 'rehearsal_pair'))
  parser.add_argument('--alignment', action='store_true')
  parser.add_argument('--worker', choices=('jax', 'torch'), default=None)
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  seeds = parse_seeds(args.seeds)
  if args.worker:
    worker(args.worker, seeds, args.steps, args.out, args.alignment)
    return
  os.makedirs(args.out_dir, exist_ok=True)
  results = {}
  for package in ('jax', 'torch'):
    out = os.path.join(args.out_dir, f'{package}.json')
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS='cpu')
    subprocess.run(
        [sys.executable, os.path.abspath(__file__), f'--worker={package}',
         f'--seeds={args.seeds}', f'--steps={args.steps}', f'--out={out}']
        + (['--alignment'] if args.alignment else []),
        env=env, check=True)
    with open(out) as f:
      rows = json.load(f)
    results[package] = (alignment_summary if args.alignment else summary)(
        rows)
    print(package, json.dumps(results[package]), flush=True)
  if args.alignment:
    return
  a, b = results['jax'], results['torch']
  se = math.sqrt(a['reach_se'] ** 2 + b['reach_se'] ** 2)
  print(f"share z (port - JAX) = "
        f"{(b['reach_share'] - a['reach_share']) / se:.2f}", flush=True)


if __name__ == '__main__':
  main()
