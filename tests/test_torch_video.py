"""The port's image writers and episode videos, on the CPU.

GIFs (io/gif.py, native/gif_lzw.cc) decode through PIL and through the
port's own decoder bit for bit to the raster frames, with `interval_ms`
as each frame's delay; the native LZW writes the Python twin's bytes;
`png.imencode` round-trips through `imdecode` and PIL. The batched
evaluator rebuilds, from recorded (si, offset, theta, goal), the atom
clouds the JAX package rebuilds (within 1e-5 angstrom), writes one GIF
per recorded env, and gives the results of the same run without videos.
The rate-learner CLI with its default flags writes the JAX CLI's files.
"""

import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import plotting_utils as t_plot
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch.env import multi_dopant as t_multi
from putting_dune_torch.io import gif
from putting_dune_torch.io import png
from putting_dune_torch.pipeline import train_rate_learner as t_trl
from putting_dune_tpu import constants
from putting_dune_tpu import lattice as j_lattice

Image = pytest.importorskip('PIL.Image')


def _frames(rng, count, shape, colors):
  frames = [rng.integers(0, colors, shape).astype(np.uint8)
            for _ in range(count)]
  # A smooth frame too: long LZW runs and table resets.
  frames.append(np.repeat((np.arange(shape[1])[None] % colors).astype(
      np.uint8), shape[0], axis=0))
  return frames


@pytest.mark.parametrize('shape,colors', [((7, 9), 2), ((37, 53), 5),
                                          ((120, 100), 200), ((64, 64), 256)])
def test_native_lzw_writes_the_python_twins_bytes(shape, colors):
  rng = np.random.default_rng(colors)
  min_code_size = max(2, gif._table_bits(colors) + 1)
  for frame in _frames(rng, 2, shape, colors):
    want = gif.lzw_encode_py(frame, min_code_size)
    assert gif.lzw_encode(frame, min_code_size) == want
    np.testing.assert_array_equal(
        gif.lzw_decode(want, min_code_size, frame.size), frame.reshape(-1))


@pytest.mark.parametrize('interval_ms', [200, 50])
def test_gif_decodes_bit_for_bit_through_pil_and_the_port(interval_ms):
  rng = np.random.default_rng(interval_ms)
  palette = rng.integers(0, 256, (40, 3)).astype(np.uint8)
  frames = _frames(rng, 3, (90, 110), 40)
  data = gif.encode(frames, palette, interval_ms=interval_ms)
  ours = gif.decode(data)
  assert ours.count == len(frames) and ours.loop == 0
  assert ours.delays_ms == [interval_ms] * len(frames)
  image = Image.open(io.BytesIO(data))
  for i, frame in enumerate(frames):
    np.testing.assert_array_equal(ours.frames[i], palette[frame])
    image.seek(i)
    assert image.info['duration'] == interval_ms
    np.testing.assert_array_equal(np.asarray(image.convert('RGB')),
                                  palette[frame])
  assert gif.decode(data, limit=1).count == len(frames)


def test_video_gif_holds_the_raster_frames(tmp_path):
  lattice = np.asarray(j_lattice.make_lattice(12).positions)
  numbers = np.full(len(lattice), constants.CARBON)
  numbers[5] = constants.SILICON
  video = t_plot.generate_video_from_trajectory(
      [lattice, lattice + 0.4], [numbers, numbers],
      goal_position=np.array([1.0, 2.0]), interval_ms=200)
  path = str(tmp_path / 'v.gif')
  assert video.save(path) == os.path.getsize(path)
  with open(path, 'rb') as f:
    data = f.read()
  decoded = gif.decode(data)
  image = Image.open(io.BytesIO(data))
  for i, frame in enumerate(video.frames):
    assert frame.shape == (500, 500, 3)
    np.testing.assert_array_equal(decoded.frames[i], frame)
    image.seek(i)
    np.testing.assert_array_equal(np.asarray(image.convert('RGB')), frame)


@pytest.mark.parametrize('shape', [(31, 17, 3), (5, 8), (200, 300, 3)])
def test_png_imencode_round_trips(shape):
  pixels = np.random.default_rng(len(shape)).integers(
      0, 256, shape).astype(np.uint8)
  data = png.imencode(pixels)
  back = png.imdecode(data)
  if pixels.ndim == 3:
    back = back[..., ::-1]  # imdecode gives cv2's BGR
  np.testing.assert_array_equal(back, pixels)
  np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                pixels)


def _recorded(rng, cap, nvid, dopants, num_atoms):
  return dict(
      si=np.stack([np.stack([rng.choice(num_atoms, dopants, replace=False)
                             for _ in range(nvid)]) for _ in range(cap)]),
      offset=rng.normal(size=(cap, nvid, 2)).astype(np.float32),
      theta=rng.uniform(0, 2 * np.pi, (cap, nvid)).astype(np.float32),
      goal=rng.normal(size=(cap, nvid, dopants, 2)).astype(np.float32) * 5)


@pytest.mark.parametrize('dopants', [1, 3])
def test_recorded_poses_rebuild_the_jax_atom_clouds(dopants):
  rng = np.random.default_rng(dopants)
  j_lat = j_lattice.make_lattice(50)
  video = _recorded(rng, 6, 2, dopants, j_lat.num_atoms)
  lattice = t_lattice.make_lattice(50)
  for i in range(2):
    positions, numbers, goal = t_eval_lib.video_scenes(lattice, video, i, 5)
    np.testing.assert_array_equal(goal, video['goal'][0, i])
    for t in range(5):
      # The JAX package's _save_batched_videos, step by step.
      world = np.asarray(j_lattice.world_positions(
          j_lat, jnp.asarray(video['offset'][t, i]),
          jnp.asarray(video['theta'][t, i])))
      want = np.full(world.shape[0], constants.CARBON)
      want[np.asarray(video['si'][t, i], np.int64)] = constants.SILICON
      assert np.abs(positions[t] - world).max() <= 1e-5
      np.testing.assert_array_equal(numbers[t], want)


def _single_env(batch, step_limit):
  exp = t_registry.create_eval_experiment('greedy_simple_rates')
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=batch,
      step_limit=step_limit, device='cpu')
  policy = exp.get_policy(exp.get_adapters_and_goal(), 'cpu')
  return env, getattr(policy, 'policy', lambda: policy)()


def _multi_env(batch, step_limit):
  env = t_multi.MultiDopantEnv(
      lattice=t_lattice.make_lattice(20),
      rate_fn=t_rates.simple_canonical_rates, batch_size=batch,
      num_dopants=2, step_limit=step_limit, device='cpu')
  spec = env.action_spec()

  def policy(gen, obs):
    return torch.rand((batch, spec.shape[0]), generator=gen) * 2 - 1

  return env, policy


@pytest.mark.parametrize('make_env', [_single_env, _multi_env])
def test_batched_videos_leave_the_results_alone(tmp_path, make_env):
  seeds = list(range(6))
  env, policy = make_env(len(seeds), 5)
  plain = t_eval_lib.evaluate_batched(env, policy, seeds)
  env, policy = make_env(len(seeds), 5)
  taped = t_eval_lib.evaluate_batched(env, policy, seeds, video_envs=3,
                                      video_save_dir=str(tmp_path))
  # NaN-aware: agent seconds are NaN in batched results.
  np.testing.assert_equal([dataclasses.astuple(r) for r in taped],
                          [dataclasses.astuple(r) for r in plain])
  assert sorted(os.listdir(tmp_path)) == ['0.gif', '1.gif', '2.gif']
  for r in taped[:3]:
    with open(tmp_path / f'{r.seed}.gif', 'rb') as f:
      video = gif.decode(f.read(), limit=1)
    assert video.count == min(r.num_actions_taken + 1, 6)
    assert video.frames[0].shape == (500, 500, 3)
    assert video.delays_ms[0] == 200


@pytest.mark.parametrize('distill', [False, True])
def test_rate_learner_cli_writes_the_jax_files(monkeypatch, tmp_path,
                                               distill):
  from putting_dune_tpu.io import records as j_records
  from putting_dune_tpu.pipeline import train_rate_learner as j_trl
  from test_torch_pipeline_io import _simulate

  source = str(tmp_path / 'trajectories.tfrecords')
  j_records.write_records(source, [_simulate(seed) for seed in range(3)])
  common = dict(source_path=source, epochs=2, num_models=2, batch_size=8,
                hidden_dimensions=(8,), epoch_chunk=1)
  if distill:
    # The CLI distils for DistillConfig's 10,000 epochs; two show that the
    # rates plotted are the distilled model's.
    from putting_dune_torch.rate_learning import config as t_config
    from putting_dune_torch.rate_learning import predictor as t_predictor

    original = t_predictor.LearnedRatePredictor.distill
    monkeypatch.setattr(
        t_predictor.LearnedRatePredictor, 'distill',
        lambda self, data: original(self, data,
                                    t_config.DistillConfig(epochs=2)))
  _, _, predictor = t_trl.main(t_trl.Args(
      workdir=str(tmp_path / 't'), device='cpu', distill=distill, **common))
  assert predictor.num_models == (1 if distill else 2)
  j_trl.main(j_trl.Args(workdir=str(tmp_path / 'j'), distill=False,
                        **common))
  got = sorted(os.listdir(tmp_path / 't'))
  assert got == sorted(os.listdir(tmp_path / 'j'))
  assert {'metrics.npz', 'avg_context_rates.png', 'train_loss.png'} <= set(
      got)
  for name in got:
    if name.endswith('.png'):
      with open(tmp_path / 't' / name, 'rb') as f:
        assert png.imdecode(f.read()).std() > 0
