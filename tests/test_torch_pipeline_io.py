"""The pipeline CLIs on record files, in both packages.

The slice as a whole: the same input record file (trajectories from the
JAX simulator, with images) goes through both packages'
`trajectories_to_transitions` CLI and the two output files are byte for
byte equal. Around it: `align_trajectories` (FOVs within 1e-4 A, the
tolerance of tests/test_torch_image_alignment.py), `transitions_to_
datapoints` and `stack_data` (element-wise equal, equal drop counts),
`train_rate_learner.main` (2 models, 2 epochs; the written predictor read
by both packages agrees within 1e-6, the tolerance of the port's
checkpoint tests), `import_microscope_data`, `convert_riegeli`, the
artifact bundles and their cache rules, the agent logger and the
simulator observer.
"""

import csv
import datetime as dt
import io
import json
import os
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import microscope_agent as t_ma
from putting_dune_torch import microscope_data as t_md
from putting_dune_torch import registry as t_registry
from putting_dune_torch import simulator as t_simulator
from putting_dune_torch import simulator_observers as t_observers
from putting_dune_torch import structures as t_structures
from putting_dune_torch.image_alignment import inference as t_inference
from putting_dune_torch.io import artifacts as t_artifacts
from putting_dune_torch.io import records as t_records
from putting_dune_torch.pipeline import align_trajectories as t_align
from putting_dune_torch.pipeline import convert_riegeli as t_convert
from putting_dune_torch.pipeline import import_microscope_data as t_imd
from putting_dune_torch.pipeline import train_rate_learner as t_trl
from putting_dune_torch.pipeline import trajectories_to_transitions as t_t2t
from putting_dune_torch.rate_learning import config as t_config
from putting_dune_torch.rate_learning import predictor as t_predictor
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import microscope_agent as j_ma
from putting_dune_tpu import microscope_data as j_md
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu import simulator as j_simulator
from putting_dune_tpu import structures as j_structures
from putting_dune_tpu.experiments import registry as j_registry
from putting_dune_tpu.io import artifacts as j_artifacts
from putting_dune_tpu.io import records as j_records
from putting_dune_tpu.pipeline import align_trajectories as j_align
from putting_dune_tpu.pipeline import convert_riegeli as j_convert
from putting_dune_tpu.pipeline import import_microscope_data as j_imd
from putting_dune_tpu.pipeline import train_rate_learner as j_trl
from putting_dune_tpu.pipeline import trajectories_to_transitions as j_t2t
from putting_dune_tpu.rate_learning import config as j_config
from putting_dune_tpu.rate_learning import predictor as j_predictor

FOV_TOL = 1e-4  # tests/test_torch_image_alignment.py's do_alignment bar
PREDICTOR_TOL = 1e-6  # tests/test_torch_rate_learning.py's checkpoint bar


def _simulate(seed, num_steps=12):
  """One JAX-simulator trajectory (20 columns) with small images, as the
  JAX package's pipeline tests make them."""
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


@pytest.fixture(scope='module')
def source(tmp_path_factory):
  """The shared input: JAX-written trajectories, as .tfrecords."""
  path = str(tmp_path_factory.mktemp('pipeline') / 'trajectories.tfrecords')
  j_records.write_records(path, [_simulate(seed) for seed in range(3)])
  return path


def _run_jax_cli(monkeypatch, main, argv):
  monkeypatch.setattr(sys, 'argv', ['cli'] + argv)
  return main()


# --- the slice as a whole: byte-identical transitions ------------------------


@pytest.mark.parametrize('ext', ['.tfrecords', '.riegeli'])
@pytest.mark.parametrize(
    'flag', [[], ['--previous_controls_at_current_timestep']],
    ids=['a_t-1', 'a_t'])
def test_trajectories_to_transitions_clis_write_identical_files(
    monkeypatch, tmp_path, source, ext, flag):
  port_out, jax_out = str(tmp_path / f'p{ext}'), str(tmp_path / f'j{ext}')
  n = t_t2t.main([f'--source_path={source}', f'--target_path={port_out}']
                 + flag)
  _run_jax_cli(monkeypatch, j_t2t.main,
               [f'--source_path={source}', f'--target_path={jax_out}'] + flag)
  assert n == 3 * 12
  with open(port_out, 'rb') as f, open(jax_out, 'rb') as g:
    assert f.read() == g.read()


def test_riegeli_input_gives_the_same_transitions(tmp_path, source):
  riegeli = str(tmp_path / 'in.riegeli')
  t_convert.convert(source, riegeli)
  out = str(tmp_path / 'from_riegeli.tfrecords')
  t_t2t.main([f'--source_path={riegeli}', f'--target_path={out}'])
  direct = str(tmp_path / 'direct.tfrecords')
  t_t2t.main([f'--source_path={source}', f'--target_path={direct}'])
  assert open(out, 'rb').read() == open(direct, 'rb').read()


# --- datapoints --------------------------------------------------------------


@pytest.mark.parametrize('previous', [True, False])
def test_datapoints_and_stack_data_equal_the_jax_package(source, previous):
  t_tr = t_t2t.trajectories_to_transitions(
      t_records.read_records(source, t_md.Trajectory),
      previous_controls_at_current_timestep=previous)
  j_tr = j_t2t.trajectories_to_transitions(
      j_records.read_records(source, j_md.Trajectory),
      previous_controls_at_current_timestep=previous)
  t_points, t_counts = t_trl.transitions_to_datapoints(t_tr)
  j_points, j_counts = j_trl.transitions_to_datapoints(j_tr)
  assert t_counts == j_counts
  assert len(t_points) == len(j_points) == t_counts['kept']
  if previous:
    assert t_counts['kept'] > 0
  for a, b in zip(t_points, j_points):
    assert a.next_state == b.next_state
    np.testing.assert_array_equal(a.beam_pos, b.beam_pos)
    assert (a.seconds_between, a.current, a.voltage) == (
        b.seconds_between, b.current, b.voltage)
  if not t_points:
    return
  for kwargs in (dict(use_current=True, use_voltage=True),
                 dict(use_voltage=True, dwell_time_in_context=True), {}):
    got, want = t_trl.stack_data(t_points, **kwargs), j_trl.stack_data(
        j_points, **kwargs)
    assert sorted(got) == sorted(want)
    for k in got:
      assert got[k].dtype == want[k].dtype
      np.testing.assert_array_equal(got[k], want[k])


# --- train_rate_learner ------------------------------------------------------


def test_train_rate_learner_main_writes_a_predictor_both_read(tmp_path,
                                                             source):
  workdir = str(tmp_path / 'run')
  args = t_trl._parse_args([
      f'--source_path={source}', f'--workdir={workdir}', '--epochs=2',
      '--num_models=2', '--hidden_dimensions', '16', '16', '--nodistill',
      '--noplot_metrics', '--novisualize_rates', '--epoch_chunk=1',
      '--previous_controls_at_current_timestep', '--device=cpu'])
  stacked, counts, predictor = t_trl.main(args)
  assert counts['kept'] == len(stacked['dt']) > 0
  metrics = np.load(os.path.join(workdir, 'metrics.npz'))
  assert all(metrics[k].shape == (2, 2) and np.isfinite(metrics[k]).all()
             for k in metrics.files)
  x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
  want = predictor.apply_model(x).numpy()
  j_pred = j_predictor.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(0), config=j_config.RateLearningConfig())
  j_pred.load(workdir)
  np.testing.assert_allclose(np.asarray(j_pred.apply_model(jnp.asarray(x))),
                             want, atol=PREDICTOR_TOL)
  back = t_predictor.LearnedRatePredictor(device='cpu')
  back.load(workdir)
  assert back.config.beam_units == 'angstroms' and back.num_models == 2
  np.testing.assert_allclose(back.apply_model(x).numpy(), want,
                             atol=PREDICTOR_TOL)
  # The rate function the planners take: finite, non-negative rates.
  rates = back.as_rate_function()(
      torch.zeros(4, 2), torch.randn(4, 3, 2, generator=torch.Generator()
                                     .manual_seed(0)), torch.ones(4, 2))
  assert torch.isfinite(rates).all() and (rates >= 0).all()


def test_train_rate_learner_distills_to_one_model(monkeypatch, tmp_path,
                                                  source):
  # The CLI distils for DistillConfig's 10,000 epochs, as the JAX package
  # does; two are enough to show that the distilled model is what is saved.
  distill = t_predictor.LearnedRatePredictor.distill
  monkeypatch.setattr(
      t_predictor.LearnedRatePredictor, 'distill',
      lambda self, data: distill(self, data, t_config.DistillConfig(epochs=2)))
  workdir = str(tmp_path / 'distilled')
  _, _, predictor = t_trl.main(t_trl.Args(
      source_path=source, workdir=workdir, epochs=1, num_models=2,
      hidden_dimensions=(8,), plot_metrics=False, visualize_rates=False,
      device='cpu', previous_controls_at_current_timestep=True))
  assert predictor.num_models == 1
  with open(os.path.join(workdir, 'config.json')) as f:
    assert json.load(f)['num_models_current'] == 1
  x = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
  j_pred = j_predictor.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(0), config=j_config.RateLearningConfig())
  j_pred.load(workdir)
  np.testing.assert_allclose(np.asarray(j_pred.apply_model(jnp.asarray(x))),
                             predictor.apply_model(x).numpy(),
                             atol=PREDICTOR_TOL)


def test_train_rate_learner_refuses_what_is_not_ported(tmp_path, source):
  base = dict(source_path=source, workdir=str(tmp_path / 'x'), device='cpu')
  # The plots are ported now; the sklearn learners still wait, and are
  # refused with the default plot flags too.
  with pytest.raises(NotImplementedError, match='sklearn'):
    t_trl.main(t_trl.Args(learner_type='random_forest', plot_metrics=False,
                          visualize_rates=False, **base))
  with pytest.raises(NotImplementedError, match='sklearn'):
    t_trl.main(t_trl.Args(learner_type='knn', **base))
  assert not os.path.exists(base['workdir'])


def test_classification_network_trains(tmp_path, source):
  args = t_trl.Args(
      source_path=source, workdir=str(tmp_path / 'cls'), epochs=1,
      num_models=2, hidden_dimensions=(8,), distill=False,
      plot_metrics=False, visualize_rates=False, augment_data=False,
      learner_type='classification_network', device='cpu',
      previous_controls_at_current_timestep=True)
  stacked, _, predictor = t_trl.main(args)
  assert stacked['context'].shape[1] == 3  # current, voltage, dwell
  np.testing.assert_array_equal(stacked['dt'], 1.0)
  # Both packages read the written predictor back at its input width:
  # position (2) and the three context columns.
  x = np.random.default_rng(2).normal(size=(16, 5)).astype(np.float32)
  want = predictor.apply_model(x).numpy()
  back = t_predictor.LearnedRatePredictor(device='cpu')
  back.load(args.workdir)
  assert back.context_dim == 5
  np.testing.assert_allclose(back.apply_model(x).numpy(), want,
                             atol=PREDICTOR_TOL)
  j_pred = j_predictor.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(0), config=j_config.RateLearningConfig())
  j_pred.load(args.workdir)
  np.testing.assert_allclose(np.asarray(j_pred.apply_model(jnp.asarray(x))),
                             want, atol=PREDICTOR_TOL)
  # A rate network's checkpoint read into the same predictor narrows it.
  narrow = str(tmp_path / 'narrow')
  t_predictor.LearnedRatePredictor(device='cpu').save(narrow)
  back.load(narrow)
  assert back.context_dim == 4
  assert back.apply_model(x[:, :4]).shape == (16, 3)


# --- align_trajectories ------------------------------------------------------


def test_align_trajectories_clis_agree(monkeypatch, tmp_path):
  observations, _ = t_ma.drifting_sequence(5, frames=6, device='cpu')
  source = str(tmp_path / 'drifting.tfrecords')
  t_records.write_records(source, [t_md.Trajectory(tuple(observations))])
  port_out, jax_out = str(tmp_path / 'p.riegeli'), str(tmp_path / 'j.riegeli')
  weights = t_inference.SHIPPED_ALIGNER_DIR
  t_align.main(t_align._parse_args([
      f'--source_path={source}', f'--target_path={port_out}',
      f'--aligner_workdir={weights}', '--device=cpu']))
  j_align.main(j_align.Args(source_path=source, target_path=jax_out,
                            aligner_workdir=weights))
  (got,) = t_records.read_records(port_out, t_md.Trajectory)
  (want,) = j_records.read_records(jax_out, j_md.Trajectory)
  assert len(got.observations) == len(want.observations) == 6
  for a, b in zip(got.observations, want.observations):
    np.testing.assert_allclose(a.fov.lower_left, b.fov.lower_left,
                               atol=FOV_TOL)
    np.testing.assert_allclose(a.fov.upper_right, b.fov.upper_right,
                               atol=FOV_TOL)
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.grid.atom_positions, b.grid.atom_positions)


# --- import_microscope_data --------------------------------------------------


def _write_ndata1(path, data, metadata=None):
  buf = io.BytesIO()
  np.save(buf, data)
  with zipfile.ZipFile(path, 'w') as zf:
    zf.writestr('data.npy', buf.getvalue())
    if metadata is not None:
      zf.writestr('metadata.json', json.dumps(metadata))


@pytest.fixture
def ndata_root(tmp_path):
  """The ORNL fixture of tests/test_aux_subsystems.py, one frame without
  beam fields."""
  n, h, w = 4, 32, 32
  rng = np.random.default_rng(0)
  images = rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32)
  labels = np.zeros((n, 16, 16), np.uint8)
  metadata = {'metadata': {}}
  for t in range(n):
    coords = rng.uniform(0, 16, (6, 2)).tolist()
    frame = {
        'ADF readouttime': 2.0,
        'All coordinates': {'0': coords},
        'All parameters': {'image_parameters': [2.0]},
        'Blast coordinates': {'Dopants': [coords[0]]},
        'Beam location': [coords[1]],
        'Beam dwelltime': 1.5,
        'Pixelshifts': [1, 0],
    }
    if t == 2:
      del frame['Beam location']
    metadata['metadata'][str(t)] = frame
  dataset = tmp_path / 'ornl' / 'run1'
  dataset.mkdir(parents=True)
  _write_ndata1(dataset / 'ADF-stack-000.ndata1', images)
  _write_ndata1(dataset / 'Label-stack-000.ndata1', labels, metadata)
  return tmp_path / 'ornl'


@pytest.mark.parametrize('output_format', ['tfrecords', 'riegeli'])
@pytest.mark.parametrize('image_format', ['ndarray', 'tensorproto'])
def test_import_microscope_data_writes_the_jax_package_files(
    monkeypatch, tmp_path, ndata_root, output_format, image_format):
  flags = [f'--directory={ndata_root}', f'--output_format={output_format}',
           f'--image_format={image_format}']
  t_imd.main(flags + [f'--output_dir={tmp_path / "p"}'])
  _run_jax_cli(monkeypatch, j_imd.main,
               flags + [f'--output_dir={tmp_path / "j"}'])
  name = f'run1.{output_format}'
  got = open(tmp_path / 'p' / name, 'rb').read()
  assert got == open(tmp_path / 'j' / name, 'rb').read()
  (trajectory,) = t_records.read_records(str(tmp_path / 'p' / name),
                                         t_md.Trajectory)
  assert len(trajectory.observations) == 4
  obs0 = trajectory.observations[0]
  assert obs0.image.shape == (32, 32, 1)
  assert (obs0.grid.atomic_numbers == 14).sum() == 1
  assert obs0.controls[0].dwell_time == dt.timedelta(seconds=1.5)
  assert trajectory.observations[2].controls == ()
  assert (trajectory.observations[1].fov.lower_left[0]
          > obs0.fov.lower_left[0])


def test_import_microscope_data_without_datasets_exits(tmp_path):
  with pytest.raises(SystemExit):
    t_imd.main([f'--directory={tmp_path}', f'--output_dir={tmp_path / "o"}'])


# --- convert_riegeli ---------------------------------------------------------


def test_convert_riegeli_both_ways_as_the_jax_package(tmp_path):
  payloads = [b'a', b'', b'bb' * 1000]
  src = str(tmp_path / 'data.riegeli')
  j_records.write_records(src, payloads)
  for tool in (t_convert, j_convert):
    dst = str(tmp_path / f'{tool.__name__.split(".")[0]}.tfrecords')
    assert tool.convert(src, dst) == 3
    assert t_records.read_records(dst) == payloads
  back_t, back_j = str(tmp_path / 'bt.riegeli'), str(tmp_path / 'bj.riegeli')
  t_convert.convert(str(tmp_path / 'putting_dune_torch.tfrecords'), back_t)
  j_convert.convert(str(tmp_path / 'putting_dune_tpu.tfrecords'), back_j)
  assert open(back_t, 'rb').read() == open(back_j, 'rb').read()
  with pytest.raises(ValueError, match='riegeli'):
    t_convert.main(t_convert.Args(source_path='a.tfrecords',
                                  target_path='b.tfrecords'))
  args = t_convert._parse_args([f'--source_path={src}',
                                f'--target_path={tmp_path / "c.tfrecords"}'])
  t_convert.main(args)
  assert t_records.read_records(args.target_path) == payloads


# --- artifacts ---------------------------------------------------------------


def _model_dir(root, payload=b'\x01\x02' * 100):
  src = root / 'my_model'
  (src / 'sub').mkdir(parents=True, exist_ok=True)
  (src / 'params.msgpack').write_bytes(payload)
  (src / 'meta.json').write_text('{"kind": "mlp"}')
  (src / 'sub' / 'extra.bin').write_bytes(b'xyz')
  return src


def test_artifacts_cross_between_the_packages(tmp_path):
  src = _model_dir(tmp_path)
  for pack, unpack, name in ((t_artifacts.pack, j_artifacts.unpack, 'pj'),
                             (j_artifacts.pack, t_artifacts.unpack, 'jp')):
    archive = str(tmp_path / f'{name}.zip')
    manifest = pack(str(src), archive)
    assert manifest == j_artifacts.build_manifest(str(src))
    out = unpack(archive, str(tmp_path / name))
    assert out.endswith('my_model')
    for rel in manifest['files']:
      assert (src / rel).read_bytes() == open(os.path.join(out, rel),
                                              'rb').read()
  # The shipped detector bundle survives the trip and still loads.
  weights = os.path.join(os.path.dirname(j_registry.__file__),
                         'model_weights', 'atom_detector')
  archive = str(tmp_path / 'det.zip')
  t_artifacts.pack(weights, archive)
  out = t_artifacts.unpack(archive, str(tmp_path / 'zoo'))
  assert open(os.path.join(out, 'params.msgpack'), 'rb').read() == open(
      os.path.join(weights, 'params.msgpack'), 'rb').read()


def test_artifacts_reject_tampering(tmp_path):
  src = _model_dir(tmp_path)
  archive = str(tmp_path / 'm.zip')
  manifest = t_artifacts.pack(str(src), archive)
  with zipfile.ZipFile(archive) as zf:
    contents = {n: zf.read(n) for n in zf.namelist()}
  contents['params.msgpack'] = b'\x00' + contents['params.msgpack'][1:]
  bad = str(tmp_path / 'bad.zip')
  with zipfile.ZipFile(bad, 'w') as zf:
    for n, data in contents.items():
      zf.writestr(n, data)
  with pytest.raises(ValueError, match='Hash mismatch'):
    t_artifacts.unpack(bad, str(tmp_path / 'dest2'))
  evil = str(tmp_path / 'evil.zip')
  with zipfile.ZipFile(evil, 'w') as zf:
    m = dict(manifest, files={'../../escape.bin': {'sha256': '0' * 64,
                                                   'bytes': 1}})
    zf.writestr(t_artifacts.MANIFEST_NAME, json.dumps(m))
    zf.writestr('../../escape.bin', b'!')
  with pytest.raises(ValueError, match='Unsafe path'):
    t_artifacts.unpack(evil, str(tmp_path / 'dest3'))
  with pytest.raises(ValueError, match='MANIFEST'):
    with zipfile.ZipFile(str(tmp_path / 'plain.zip'), 'w') as zf:
      zf.writestr('a', b'b')
    t_artifacts.unpack(str(tmp_path / 'plain.zip'), str(tmp_path / 'd4'))


def test_resolve_artifact_cache_rules(tmp_path, monkeypatch):
  src = tmp_path / 'model'
  src.mkdir()
  (src / 'params.msgpack').write_bytes(b'v1-weights')
  archive = str(tmp_path / 'model.zip')
  t_artifacts.pack(str(src), archive)
  cache = str(tmp_path / 'cache')
  assert t_artifacts.resolve_artifact(str(src), cache_dir=cache) == str(src)
  out = t_artifacts.resolve_artifact(archive, cache_dir=cache)
  assert open(os.path.join(out, 'params.msgpack'), 'rb').read() == (
      b'v1-weights')
  assert t_artifacts.resolve_artifact(archive, cache_dir=cache) == out
  assert t_artifacts.resolve_artifact(f'file://{archive}',
                                      cache_dir=cache) == out
  # A partial extraction (no completion marker) is extracted again.
  marker = os.path.join(os.path.dirname(out), '.complete')
  os.remove(marker)
  with open(os.path.join(out, 'params.msgpack'), 'wb') as f:
    f.write(b'par')
  assert t_artifacts.resolve_artifact(archive, cache_dir=cache) == out
  assert open(os.path.join(out, 'params.msgpack'), 'rb').read() == (
      b'v1-weights')
  # A re-packed bundle at the same path is extracted anew.
  (src / 'params.msgpack').write_bytes(b'v2-weights-longer')
  t_artifacts.pack(str(src), archive)
  os.utime(archive, ns=(1, 1))
  out2 = t_artifacts.resolve_artifact(archive, cache_dir=cache)
  assert open(os.path.join(out2, 'params.msgpack'), 'rb').read() == (
      b'v2-weights-longer')
  with pytest.raises(ValueError, match='scheme'):
    t_artifacts.resolve_artifact('ftp://x/y.zip', cache_dir=cache)
  with pytest.raises(FileNotFoundError):
    t_artifacts.resolve_artifact(str(tmp_path / 'nope.zip'), cache_dir=cache)
  # A gs:// bundle the public endpoint refuses: no authenticated fallback.
  # The download is refused here without touching the network.
  import urllib.request

  def refuse(url, target):
    raise OSError(f'403 refused: {url}')

  monkeypatch.setattr(urllib.request, 'urlretrieve', refuse)
  with pytest.raises(RuntimeError, match='ROADMAP queue 1, IO'):
    t_artifacts.resolve_artifact('gs://private-bucket/m.zip', cache_dir=cache)
  assert not [p for p in os.listdir(cache) if '.tmp-' in p]


def test_artifacts_cli(tmp_path, capsys):
  src = _model_dir(tmp_path)
  archive = str(tmp_path / 'cli.zip')
  t_artifacts.main(['pack', f'--model_dir={src}', f'--archive={archive}'])
  t_artifacts.main(['unpack', f'--archive={archive}',
                    f'--target_dir={tmp_path / "cli_out"}'])
  t_artifacts.main(['fetch', f'--uri={archive}',
                    f'--cache_dir={tmp_path / "cli_cache"}'])
  out = capsys.readouterr().out
  assert 'Packed my_model (3 files)' in out and 'Unpacked' in out
  assert os.path.exists(tmp_path / 'cli_out' / 'my_model' / 'meta.json')


# --- the agent logger --------------------------------------------------------


def test_microscope_agent_logger_writes_the_jax_package_files(tmp_path,
                                                              source):
  observations = {
      'p': t_records.read_records(source, t_md.Trajectory)[:2],
      'j': j_records.read_records(source, j_md.Trajectory)[:2]}
  for name, (ma, registry, extra) in {
      'p': (t_ma, t_registry, dict(device='cpu')),
      'j': (j_ma, j_registry, {})}.items():
    experiment = registry.create_microscope_experiment('greedy_on_neighbor')
    rng = np.random.default_rng(1)
    with ma.MicroscopeAgentLogger(ma.MicroscopeAgent(rng, experiment,
                                                     **extra),
                                  logdir=str(tmp_path / name)) as agent:
      for trajectory in observations[name]:
        agent.reset(rng, trajectory.observations[0])
        for obs in trajectory.observations:
          agent.step(obs)
  for file in ('trajectories.tfrecords', 'steps.csv', 'episodes.csv'):
    got = open(tmp_path / 'p' / file, 'rb').read()
    assert got == open(tmp_path / 'j' / file, 'rb').read(), file
  stored = t_records.read_records(
      str(tmp_path / 'p' / 'trajectories.tfrecords'), t_md.Trajectory)
  assert [len(t.observations) for t in stored] == [13, 13]
  with open(tmp_path / 'p' / 'episodes.csv') as f:
    assert [row['episode_steps'] for row in csv.DictReader(f)] == ['13',
                                                                   '13']


# --- the simulator observer --------------------------------------------------


def test_event_observer_records_the_stream():
  lattice = t_lattice.make_lattice(20, 'cpu')
  config = t_simulator.SimulatorConfig(grid_columns=20)
  gen = torch.Generator().manual_seed(0)
  observer = t_observers.EventObserver()
  state, obs = t_simulator.reset(gen, lattice, config=config, batch_size=1)
  observer.record_reset(state, obs)
  control = t_structures.BeamControl(
      position=torch.full((1, 2), 0.5), dwell_seconds=torch.full((1,), 10.0))
  state, obs, result = t_simulator.step(
      state, gen, control, lattice,
      lambda si, nbr, beam: torch.full(si.shape[:-1] + (3,), 5.0),
      config=config, record_events=8)
  observer.record_step(state, obs, result, control=control)
  kinds = [e.event_type for e in observer.events]
  types = t_observers.SimulatorEventType
  assert kinds[:2] == [types.RESET, types.FOV_CHANGE]
  assert kinds[2] == types.APPLY_CONTROL and kinds[-1] == types.TAKE_IMAGE
  transitions = [e for e in observer.events if e.event_type == types.TRANSITION]
  assert len(transitions) >= 1  # total rate 15/s over 10 s
  assert transitions[0].data['time_since_control'] > 0
  times = [e.data['time_since_control'] for e in transitions]
  assert times == sorted(times)
  observer.reset()
  assert observer.events == []
