"""The port's multi-dopant path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in putting_dune_torch in one process. Deterministic
functions are held element-wise (tolerance stated at each test); the KMC
and the reset sample, so they are held in law (threefry and Philox streams
differ) and against the numpy oracle pattern of
tests/test_multi_dopant_statistical_parity.py.
"""

import ast
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from putting_dune_torch import eval as t_eval
from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import kmc as t_kmc
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.env import env as t_env
from putting_dune_torch.env import goals as t_goals
from putting_dune_torch.env import multi_dopant as t_md
from putting_dune_torch.imaging import params as t_params
from putting_dune_torch.imaging import render as t_render
from putting_dune_tpu import eval as j_eval
from putting_dune_tpu import kmc as j_kmc
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu.agents import eval_agent as j_eval_agent
from putting_dune_tpu.agents import planner as j_planner
from putting_dune_tpu.env import multi_dopant as j_md
from putting_dune_tpu.experiments import registry as j_registry
from putting_dune_tpu.imaging import params as j_params
from putting_dune_tpu.imaging import render as j_render

torch.set_num_threads(2)

BOND = 1.42
REPO = pathlib.Path(__file__).resolve().parent.parent
T_LATTICE_20 = t_lattice.make_lattice(20)
J_LATTICE_20 = j_lattice.make_lattice(num_cols=20)
T_LATTICE_50 = t_lattice.make_lattice(50)
J_LATTICE_50 = j_lattice.make_lattice(num_cols=50)


def _t(x):
  return torch.from_numpy(np.array(x))


def _gen(seed):
  return t_env.make_generator(seed, 'cpu')


# --- the port imports nothing of JAX ------------------------------------------------


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
  banned = ('jax', 'flax', 'putting_dune_tpu', 'optax', 'orbax', 'cv2',
            'sklearn', 'dm_env', 'google', 'matplotlib', 'networkx',
            'tensorflow', 'riegeli', 'array_record', 'google_crc32c', 'PIL',
            'imageio')
  sources = sorted((REPO / 'putting_dune_torch').rglob('*.py'))
  sources.append(REPO / 'chip_smoke.py')
  assert len(sources) > 30
  names = {path.relative_to(REPO).as_posix() for path in sources}
  for module in ('config', 'data_utils', 'distill', 'losses', 'model',
                 'predictor', 'train', '__init__'):
    assert f'putting_dune_torch/rate_learning/{module}.py' in names
  assert 'putting_dune_torch/io/serialization.py' in names
  for module in ('distill', 'train_ppo', 'ppo', 'eval_agent'):
    assert f'putting_dune_torch/agents/{module}.py' in names
  for module in ('microscope_data', 'microscope_agent',
                 'alignment/__init__', 'alignment/classical',
                 'image_alignment/__init__', 'image_alignment/model',
                 'image_alignment/train', 'image_alignment/inference',
                 'atom_detection/inference', 'imaging/morphology',
                 'env/dm_env_wrapper', 'pipeline/__init__',
                 'pipeline/align_trajectories',
                 'pipeline/trajectories_to_transitions',
                 'atom_detection/train', 'atom_detection/save_model',
                 'image_alignment/data', 'image_alignment/save_model',
                 'graph_alignment/__init__', 'graph_alignment/model',
                 'graph_alignment/data', 'graph_alignment/train',
                 'utils/__init__', 'utils/checkpoints', 'utils/cli',
                 'utils/training', 'utils/profiling', 'imaging/noise',
                 'proto/__init__', 'proto/wire', 'io/__init__', 'io/native',
                 'io/records', 'io/riegeli_native', 'io/tensorproto',
                 'io/datasets', 'io/artifacts', 'io/png',
                 'pipeline/convert_riegeli', 'pipeline/import_microscope_data',
                 'pipeline/import_tfds_dataset', 'pipeline/train_rate_learner',
                 'simulator_observers', 'atom_detection/data',
                 'plotting_utils', 'utils/raster', 'io/gif',
                 'parallel/__init__', 'parallel/mesh'):
    assert f'putting_dune_torch/{module}.py' in names
  for path in sources:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [alias.name for alias in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or '']
      else:
        continue
      for name in names:
        assert name.split('.')[0] not in banned, (
            f'{path.relative_to(REPO)}:{node.lineno} imports {name}')


# --- apply_control_multi ----------------------------------------------------------


def _simple_rates_np(neighbor_pos, beam_pos):
  dist = np.linalg.norm(beam_pos - neighbor_pos, axis=-1) / BOND
  return 1.0 / ((dist * 4.0) ** 2 + 1.0)


def _oracle_multi_kmc(rng, si, beam, dwell, positions, neighbors):
  """Per-env multi-channel KMC loop in numpy."""
  si = list(si)
  d = len(si)
  elapsed = 0.0
  count = 0
  while True:
    rates = np.zeros((d, 3))
    nbr = np.stack([neighbors[s] for s in si])  # (D, 3)
    for i in range(d):
      rates[i] = _simple_rates_np(positions[nbr[i]], beam)
      for j in range(3):
        if nbr[i, j] in si:  # occupied-site mask
          rates[i, j] = 0.0
    total = rates.sum()
    elapsed += min(rng.exponential(1.0 / max(total, 1e-30)), 3600.0)
    if elapsed > dwell:
      break
    choice = rng.choice(d * 3, p=rates.reshape(-1) / total)
    si[choice // 3] = nbr[choice // 3, choice % 3]
    count += 1
  return si, count


def _kmc_setup():
  positions = T_LATTICE_20.positions.numpy()
  neighbors = T_LATTICE_20.neighbors.numpy()
  si0 = int(np.argmin(np.sum(positions**2, axis=1)))
  nbr0 = neighbors[si0]
  si1 = int([s for s in neighbors[nbr0[0]] if s != si0][0])
  # Beam on dopant 0's neighbor 1: strong rates for dopant 0, weak but
  # non-negligible for dopant 1, so both channels fire.
  return positions, neighbors, (si0, si1), positions[nbr0[1]]


def _run_port_kmc(seed, n, si_init, beam, dwell, max_events=None):
  return t_kmc.apply_control_multi(
      _gen(seed), T_LATTICE_20, torch.zeros((n, 2)), torch.zeros((n,)),
      _t(np.tile(np.asarray(si_init, np.int64), (n, 1))),
      _t(np.tile(beam.astype(np.float32), (n, 1))),
      torch.full((n,), dwell), t_rates.simple_canonical_rates,
      max_events=max_events)


def _run_jax_kmc(seed, n, si_init, beam, dwell, max_events=None):
  return j_kmc.apply_control_multi(
      jax.random.PRNGKey(seed), J_LATTICE_20, np.zeros((n, 2), np.float32),
      np.zeros((n,), np.float32),
      np.tile(np.asarray(si_init, np.int32), (n, 1)),
      np.tile(beam.astype(np.float32), (n, 1)),
      np.full((n,), dwell, np.float32), j_rates.simple_canonical_rates,
      max_events=max_events)


def _z(a, b):
  """z statistic of the difference of two sample means."""
  se = np.sqrt(a.var() / len(a) + b.var() / len(b))
  return abs(a.mean() - b.mean()) / max(se, 1e-12)


def test_apply_control_multi_matches_jax_in_law():
  positions, _, si_init, beam = _kmc_setup()
  n, dwell = 3000, 15.0
  got = _run_port_kmc(7, n, si_init, beam, dwell)
  want = _run_jax_kmc(7, n, si_init, beam, dwell)
  got_counts = got.num_transitions.numpy()
  want_counts = np.asarray(want.num_transitions)
  assert got.si_indices.shape == (n, 2) and got.si_indices.dtype == torch.int64
  assert not bool(got.truncated.any())
  # Event counts: KS p > 0.01 and means within 4 standard errors.
  assert scipy.stats.ks_2samp(got_counts, want_counts).pvalue > 0.01
  assert _z(got_counts.astype(np.float64),
            want_counts.astype(np.float64)) < 4.0
  for dopant in range(2):
    disp = [np.linalg.norm(
        positions[np.asarray(sites)[:, dopant]] - positions[si_init[dopant]],
        axis=-1) for sites in (got.si_indices.numpy(), want.si_indices)]
    assert scipy.stats.ks_2samp(*disp).pvalue > 0.01, dopant
  # Both channels fire.
  assert (got.si_indices[:, 0] != si_init[0]).float().mean() > 0.5
  assert (got.si_indices[:, 1] != si_init[1]).float().mean() > 0.02


def test_apply_control_multi_matches_numpy_oracle():
  positions, neighbors, si_init, beam = _kmc_setup()
  n, dwell = 1500, 15.0
  got = _run_port_kmc(8, n, si_init, beam, dwell)
  rng = np.random.default_rng(123)
  ora_counts = np.zeros(n)
  ora_sites = np.zeros((n, 2), np.int64)
  for i in range(n):
    ora_sites[i], ora_counts[i] = _oracle_multi_kmc(
        rng, si_init, beam, dwell, positions, neighbors)
  got_counts = got.num_transitions.numpy().astype(np.float64)
  assert _z(got_counts, ora_counts) < 4.0, (got_counts.mean(),
                                            ora_counts.mean())
  assert scipy.stats.ks_2samp(got_counts, ora_counts).pvalue > 0.01
  for dopant in range(2):
    moved = [(sites[:, dopant] != si_init[dopant]).astype(np.float64)
             for sites in (got.si_indices.numpy(), ora_sites)]
    assert _z(*moved) < 4.0, dopant


def test_occupied_site_exclusion_is_exact():
  positions = T_LATTICE_20.positions.numpy()
  neighbors = T_LATTICE_20.neighbors.numpy()
  si0 = int(np.argmin(np.sum(positions**2, axis=1)))
  si1 = int(neighbors[si0][0])  # directly bonded pair
  beam = (positions[si0] + positions[si1]) / 2.0  # between them
  n = 2000
  got = _run_port_kmc(11, n, (si0, si1), beam, 10.0).si_indices.numpy()
  assert (got[:, 0] != got[:, 1]).all()
  want = np.asarray(_run_jax_kmc(11, n, (si0, si1), beam, 10.0).si_indices)
  adjacent = [np.mean([s[1] in neighbors[s[0]] for s in sites])
              for sites in (got, want)]
  se = np.sqrt(sum(p * (1 - p) / n for p in adjacent))
  assert abs(adjacent[0] - adjacent[1]) < 4.0 * se + 0.02, adjacent


def test_max_events_truncates_and_zero_dwell_is_identity():
  _, _, si_init, beam = _kmc_setup()
  got = _run_port_kmc(3, 64, si_init, beam, 1e4, max_events=5)
  want = _run_jax_kmc(3, 64, si_init, beam, 1e4, max_events=5)
  assert bool(got.truncated.all()) and bool(np.asarray(want.truncated).all())
  assert got.num_transitions.tolist() == [5] * 64
  assert np.asarray(want.num_transitions).tolist() == [5] * 64
  still = _run_port_kmc(3, 8, si_init, beam, 0.0)
  assert still.si_indices.tolist() == [list(si_init)] * 8
  assert still.num_transitions.tolist() == [0] * 8
  assert not bool(still.truncated.any())


# --- the env: injected states, element-wise ---------------------------------------


@pytest.mark.parametrize('num_dopants', [1, 2, 3, 4, 6])
@pytest.mark.parametrize('cols', [20, 50])
def test_initial_sites_equal(num_dopants, cols):
  t_lat = T_LATTICE_20 if cols == 20 else T_LATTICE_50
  j_lat = J_LATTICE_20 if cols == 20 else J_LATTICE_50
  got = t_md._initial_sites(t_lat, num_dopants).numpy()
  want = np.asarray(j_md._initial_sites(j_lat, num_dopants))
  np.testing.assert_array_equal(got, want)
  assert len(set(got.tolist())) == num_dopants


def _envs(batch, num_dopants, **kwargs):
  t_kwargs = dict(kwargs)
  t_envir = t_md.MultiDopantEnv(
      lattice=T_LATTICE_50, rate_fn=t_rates.simple_canonical_rates,
      batch_size=batch, num_dopants=num_dopants, device='cpu', **t_kwargs)
  j_envir = j_md.MultiDopantEnv(
      lattice=J_LATTICE_50, rate_fn=j_rates.simple_canonical_rates,
      batch_size=batch, num_dopants=num_dopants, **kwargs)
  return t_envir, j_envir


def _injected_states(seed, batch, num_dopants, at_goal=(), latched=(),
                     needs_reset=()):
  """The same state for both packages, from numpy: a random pose, dopants
  on distinct random sites near the centre, goals a few bonds away.
  `at_goal` dopants get their own position as goal; `latched` dopants are
  flagged latched; `needs_reset` envs are flagged for auto-reset."""
  rng = np.random.default_rng(seed)
  positions = T_LATTICE_50.positions.numpy()
  central = np.nonzero(np.linalg.norm(positions, axis=-1) < 8.0)[0]
  sites = np.stack([rng.choice(central, num_dopants, replace=False)
                    for _ in range(batch)]).astype(np.int64)
  offset = rng.uniform(-BOND, BOND, (batch, 2)).astype(np.float32)
  theta = rng.uniform(0, 2 * np.pi, (batch,)).astype(np.float32)
  goals = rng.uniform(-9, 9, (batch, num_dopants, 2)).astype(np.float32)
  lat = np.zeros((batch, num_dopants), bool)
  for d in latched:
    lat[:, d] = True
  needs = np.zeros((batch,), bool)
  needs[list(needs_reset)] = True
  steps = rng.integers(0, 50, (batch,)).astype(np.int32)
  consecutive = np.zeros((batch, num_dopants), np.int32)
  half = np.full((batch, 2), 12.5, np.float32)

  t_state = t_md.MultiDopantState(
      offset=_t(offset), theta=_t(theta), si_indices=_t(sites),
      fov_lower=_t(-half), fov_upper=_t(half), goals=_t(goals),
      consecutive=_t(consecutive), latched=_t(lat), steps=_t(steps),
      needs_reset=_t(needs),
      kmc_truncation_count=torch.zeros((batch,), dtype=torch.int32),
      imaging=t_params.sample_imaging_params(_gen(0), batch, device='cpu'),
      drift=torch.zeros((batch, 2)))
  if at_goal:
    t_envir = t_md.MultiDopantEnv(
        lattice=T_LATTICE_50, rate_fn=t_rates.simple_canonical_rates,
        batch_size=batch, num_dopants=num_dopants, device='cpu')
    si = t_envir._si_positions(t_state).numpy()
    for d in at_goal:
      goals[:, d] = si[:, d]
    t_state.goals = _t(goals)
  j_state = j_md.MultiDopantState(
      offset=jnp.asarray(offset), theta=jnp.asarray(theta),
      si_indices=jnp.asarray(sites.astype(np.int32)),
      fov_lower=jnp.asarray(-half), fov_upper=jnp.asarray(half),
      goals=jnp.asarray(goals), consecutive=jnp.asarray(consecutive),
      latched=jnp.asarray(lat), steps=jnp.asarray(steps),
      needs_reset=jnp.asarray(needs),
      kmc_truncation_count=jnp.zeros((batch,), jnp.int32),
      imaging=j_params.sample_imaging_params(jax.random.PRNGKey(0), batch),
      drift=jnp.zeros((batch, 2), jnp.float32))
  return t_state, j_state


def test_atom_window_matches_jax():
  t_envir, j_envir = _envs(6, 3)
  t_state, j_state = _injected_states(1, 6, 3)
  got = t_envir._atom_window(t_state)
  want = j_envir._atom_window(j_state)
  assert got.positions.shape == (6, 512, 2)
  np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
  np.testing.assert_array_equal(got.atomic_numbers.numpy(),
                                np.asarray(want.atomic_numbers))
  # In-view atoms keep lattice order: positions agree slot by slot (1e-5:
  # f32 rotation and division in two frameworks).
  np.testing.assert_allclose(got.positions.numpy(),
                             np.asarray(want.positions), atol=1e-5)
  assert (got.atomic_numbers == 14).sum(dim=1).tolist() == [3] * 6
  assert got.si_slot.tolist() == [-1] * 6


@pytest.mark.parametrize('anchor_order', ['index', 'position'])
@pytest.mark.parametrize('latched', [(), (0,), (0, 2)])
def test_anchor_index_matches_jax(anchor_order, latched):
  t_envir, j_envir = _envs(16, 3, anchor_order=anchor_order)
  t_state, j_state = _injected_states(2, 16, 3, latched=latched)
  got = t_envir._anchor_index(t_state, t_envir._si_positions(t_state))
  want = j_envir._anchor_index(j_state, j_envir._si_positions(j_state))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert not np.isin(got.numpy(), latched).any()


@pytest.mark.parametrize('anchor_order', ['index', 'position'])
@pytest.mark.parametrize('mode', ['vector', 'vector_neighbors'])
@pytest.mark.parametrize('sticky', [True, False])
def test_vector_observations_match_jax(mode, anchor_order, sticky):
  t_envir, j_envir = _envs(8, 3, observation_mode=mode,
                           anchor_order=anchor_order, sticky_goals=sticky)
  t_state, j_state = _injected_states(3, 8, 3, latched=(1,))
  got = t_envir._observation(t_state).numpy()
  want = np.asarray(j_envir._observation(j_state))
  assert got.shape == want.shape == (8, t_envir.observation_size())
  # f32 site positions in two frameworks: 1e-5 on values up to ~20 A.
  np.testing.assert_allclose(got, want, atol=1e-5)
  np.testing.assert_allclose(
      t_envir.shaping_distance(_t(got)).numpy(),
      np.asarray(j_envir.shaping_distance(jnp.asarray(want))), atol=1e-4)


@pytest.mark.parametrize('include_fov', [False, True])
def test_image_observation_matches_jax(include_fov):
  t_envir, j_envir = _envs(3, 2, observation_mode='image', image_size=64,
                           anchor_order='position', include_fov=include_fov)
  t_state, j_state = _injected_states(4, 3, 2)
  got = t_envir._observation(t_state, _gen(1))
  want = j_envir._observation(j_state, jax.random.PRNGKey(1))
  assert set(got) == set(want)
  assert got['image'].shape == want['image'].shape == (3, 64, 64, 1)
  for key in set(got) - {'image'}:
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=1e-5, err_msg=key)
  spec = t_envir.observation_spec()
  assert {k: v.shape for k, v in spec.items()} == {
      k: v.shape for k, v in j_envir.observation_spec().items()}
  assert {k: tuple(v.shape[1:]) for k, v in got.items()} == {
      k: v.shape for k, v in spec.items()}
  # The frames carry different noise draws; the clean render of the same
  # window agrees (1e-5: f32 exp and matrix product in two frameworks).
  image = got['image']
  assert bool(torch.isfinite(image).all())
  assert 0.0 <= float(image.min()) and float(image.max()) <= 1.0 + 1e-6
  t_clean = t_render.render_clean_image(
      t_envir._atom_window(t_state), t_envir._fov(t_state),
      t_state.imaging.intensity_exponent, image_size=64)
  j_clean = j_render.render_clean_image(
      j_envir._atom_window(j_state), j_envir._fov(j_state),
      jnp.asarray(t_state.imaging.intensity_exponent.numpy()), image_size=64,
      backend='xla')
  np.testing.assert_allclose(t_clean.numpy(), np.asarray(j_clean), atol=1e-5)
  with pytest.raises(ValueError, match='generator'):
    t_envir._observation(t_state)


def test_specs_match_jax():
  for mode, size in (('vector', 12), ('vector_neighbors', 18)):
    t_envir, j_envir = _envs(2, 3, observation_mode=mode)
    assert t_envir.observation_size() == j_envir.observation_size() == size
    assert t_envir.observation_spec().shape == (
        j_envir.observation_spec().shape)
    t_spec, j_spec = t_envir.action_spec(), j_envir.action_spec()
    assert (t_spec.shape, t_spec.minimum, t_spec.maximum) == (
        j_spec.shape, j_spec.minimum, j_spec.maximum)


def test_env_rejects_what_is_not_ported_or_unknown():
  kwargs = dict(lattice=T_LATTICE_20, rate_fn=t_rates.simple_canonical_rates,
                device='cpu')
  # Drift is ported: a drift env builds (it raised before).
  assert t_md.MultiDopantEnv(drift_per_frame_angstroms=0.5,
                             **kwargs).drift_per_frame_angstroms == 0.5
  for field in ('action_mode', 'observation_mode', 'anchor_order'):
    with pytest.raises(ValueError, match=field):
      t_md.MultiDopantEnv(**{field: 'nonsense'}, **kwargs)


@pytest.mark.parametrize('action_mode', ['relative', 'absolute'])
@pytest.mark.parametrize('anchor_order', ['index', 'position'])
@pytest.mark.parametrize('sticky', [True, False])
def test_step_without_dwell_matches_jax(action_mode, anchor_order, sticky):
  """dwell_seconds=0: no KMC event fires, so the step is deterministic."""
  kwargs = dict(dwell_seconds=0.0, action_mode=action_mode,
                anchor_order=anchor_order, sticky_goals=sticky,
                observation_mode='vector_neighbors', step_limit=40)
  t_envir, j_envir = _envs(12, 3, **kwargs)
  t_state, j_state = _injected_states(5, 12, 3, at_goal=(1,), latched=(2,))
  rng = np.random.default_rng(6)
  action = rng.uniform(-1.6, 1.6, (12, 2)).astype(np.float32)  # clipped
  t_new, t_ts = t_envir.step(t_state, _t(action), _gen(0))
  j_new, j_ts = j_envir.step(j_state, jnp.asarray(action),
                             jax.random.PRNGKey(0))
  for name in ('si_indices', 'consecutive', 'latched', 'steps', 'needs_reset',
               'kmc_truncation_count'):
    np.testing.assert_array_equal(
        getattr(t_new, name).numpy(), np.asarray(getattr(j_new, name)),
        err_msg=name)
  np.testing.assert_array_equal(t_ts.step_type.numpy(),
                                np.asarray(j_ts.step_type))
  # gamma ** elapsed in f32: 1e-6.
  np.testing.assert_allclose(t_ts.reward.numpy(), np.asarray(j_ts.reward),
                             atol=1e-6)
  np.testing.assert_allclose(t_ts.discount.numpy(), np.asarray(j_ts.discount),
                             atol=1e-6)
  np.testing.assert_allclose(t_ts.elapsed_seconds.numpy(),
                             np.asarray(j_ts.elapsed_seconds), atol=0)
  np.testing.assert_allclose(t_ts.observation.numpy(),
                             np.asarray(j_ts.observation), atol=1e-5)
  # Dopant 1 sits on its goal: consecutive 1 and, with sticky goals, latched
  # beside the injected latch of dopant 2; dopant 0 keeps the episode alive.
  assert t_new.consecutive[:, 1].tolist() == [1] * 12
  assert bool(t_new.latched[:, 1].all())
  assert bool(t_new.latched[:, 2].all()) == sticky
  assert not bool(t_new.latched[:, 0].any())
  assert t_ts.reward.tolist() == [0.0] * 12
  # Envs past the step limit are LAST with a nonzero discount (truncation).
  over = t_new.steps.numpy() >= 40
  assert over.any() and not over.all()
  np.testing.assert_array_equal(t_ts.step_type.numpy(),
                                np.where(over, t_env.LAST, t_env.MID))
  assert float(t_ts.discount.min()) > 0.9


def test_step_terminal_reward_and_auto_reset_flags():
  kwargs = dict(dwell_seconds=0.0, observation_mode='vector')
  t_envir, j_envir = _envs(10, 2, **kwargs)
  t_state, j_state = _injected_states(7, 10, 2, at_goal=(0, 1),
                                      needs_reset=(1, 4, 5))
  action = np.zeros((10, 2), np.float32)
  t_new, t_ts = t_envir.step(t_state, _t(action), _gen(0))
  j_new, j_ts = j_envir.step(j_state, jnp.asarray(action),
                             jax.random.PRNGKey(0))
  reset = np.zeros(10, bool)
  reset[[1, 4, 5]] = True
  for name in ('step_type', 'reward', 'discount', 'elapsed_seconds'):
    np.testing.assert_allclose(
        getattr(t_ts, name).numpy(), np.asarray(getattr(j_ts, name)),
        atol=1e-6, err_msg=name)
  for name in ('steps', 'needs_reset', 'latched', 'consecutive'):
    np.testing.assert_array_equal(
        getattr(t_new, name).numpy(), np.asarray(getattr(j_new, name)),
        err_msg=name)
  # Stepped envs reached every goal: LAST, reward gamma ** 2 s, discount 0.
  np.testing.assert_array_equal(
      t_ts.step_type.numpy(), np.where(reset, t_env.FIRST, t_env.LAST))
  assert np.all(t_ts.discount.numpy()[~reset] == 0.0)
  assert np.all(t_ts.reward.numpy()[~reset] > 0.99)
  # Reset envs: a fresh FIRST timestep and a fresh state.
  assert np.all(t_ts.reward.numpy()[reset] == 0.0)
  assert np.all(t_ts.discount.numpy()[reset] == 1.0)
  assert np.all(t_ts.elapsed_seconds.numpy()[reset] == 0.0)
  assert np.all(t_new.steps.numpy()[reset] == 0)
  assert not t_new.latched.numpy()[reset].any()
  fresh_sites = t_md._initial_sites(T_LATTICE_50, 2).numpy()
  np.testing.assert_array_equal(
      t_new.si_indices.numpy()[reset], np.tile(fresh_sites, (3, 1)))
  # Stepped envs keep their pose; reset envs drew a new one.
  np.testing.assert_array_equal(t_new.theta.numpy()[~reset],
                                t_state.theta.numpy()[~reset])
  assert np.all(t_new.theta.numpy()[reset] != t_state.theta.numpy()[reset])


@pytest.mark.parametrize('num_dopants', [2, 4])
def test_reset_goal_law(num_dopants):
  t_envir, j_envir = _envs(256, num_dopants)
  state, ts = t_envir.reset(_gen(9))
  j_state, j_ts = j_envir.reset(jax.random.PRNGKey(9))
  assert ts.observation.shape == j_ts.observation.shape
  assert ts.step_type.tolist() == [t_env.FIRST] * 256
  assert ts.discount.tolist() == [1.0] * 256 and ts.reward.tolist() == [0.0] * 256
  np.testing.assert_array_equal(state.si_indices.numpy(),
                                np.asarray(j_state.si_indices))
  assert float(state.drift.abs().max()) == 0.0
  world = t_lattice.world_positions(T_LATTICE_50, state.offset, state.theta)
  goals = state.goals.numpy()
  # Every goal is a lattice atom of this pose, and the atoms are distinct.
  d2 = ((world.numpy()[:, None, :, :] - goals[:, :, None, :]) ** 2).sum(-1)
  atoms = d2.argmin(-1)  # (B, D)
  assert d2.min(-1).max() < 1e-8
  assert all(len(set(row)) == num_dopants for row in atoms.tolist())
  # Inside the goal annulus of its dopant and inside the FOV.
  si = t_envir._si_positions(state).numpy()
  dist = np.linalg.norm(goals - si, axis=-1)
  lo, hi = t_goals.GOAL_RANGE_ANGSTROMS
  assert dist.min() >= lo and dist.max() <= hi
  assert np.all(goals >= state.fov_lower.numpy()[:, None, :])
  assert np.all(goals <= state.fov_upper.numpy()[:, None, :])
  # In law against JAX: goal distances, offsets and rotations (KS, 256
  # draws per dopant; p > 0.001 keeps 8 tests' false alarms rare).
  j_si = np.asarray(j_envir._si_positions(j_state))
  j_dist = np.linalg.norm(np.asarray(j_state.goals) - j_si, axis=-1)
  pairs = [(dist.reshape(-1), j_dist.reshape(-1)),
           (state.offset.numpy().reshape(-1),
            np.asarray(j_state.offset).reshape(-1)),
           (state.theta.numpy(), np.asarray(j_state.theta))]
  for got, want in pairs:
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3


# --- planner and checkpoints ---------------------------------------------------------


def _multi_observations(seed, batch, num_dopants):
  """(B, D*4 + 6) 'vector_neighbors' observations; the first dopant of
  every other env reads a zero (latched) goal delta."""
  rng = np.random.default_rng(seed)
  per = rng.uniform(-10, 10, (batch, num_dopants, 4)).astype(np.float32)
  per[::2, 0, 2:] = 0.0
  theta = rng.uniform(0, 2 * np.pi, (batch, 1))
  angles = theta + np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3])
  nbr = BOND * np.stack([np.cos(angles), np.sin(angles)], -1)
  return np.concatenate(
      [per.reshape(batch, -1), nbr.reshape(batch, 6)], -1).astype(np.float32)


@pytest.mark.parametrize('num_dopants', [2, 3, 4])
def test_multi_dopant_planner_policy_matches_jax(num_dopants):
  obs = _multi_observations(10, 32, num_dopants)
  cand = t_planner.make_candidate_offsets(max_radius=2 * BOND)
  kwargs = dict(num_dopants=num_dopants, dwell_seconds=5.0,
                max_distance_angstroms=2 * BOND, candidates=cand)
  want = np.asarray(j_planner.multi_dopant_planner_policy(
      None, jnp.asarray(obs), rate_fn=j_rates.simple_canonical_rates,
      **kwargs))
  got = t_planner.multi_dopant_planner_policy(
      None, _t(obs), rate_fn=t_rates.simple_canonical_rates, **kwargs).numpy()
  assert got.shape == want.shape == (32, 2)
  assert np.abs(got).max() <= 1.0 + 1e-6
  # Where the best two candidates are a near tie the packages may pick
  # either: there the JAX action's score must equal the port's best score.
  per = obs[:, :num_dopants * 4].reshape(32, num_dopants, 4)
  pick = (np.linalg.norm(per[..., 2:], axis=-1) > 1e-6).argmax(-1)
  anchor = per[np.arange(32), pick]
  single = np.concatenate([anchor[:, :2], obs[:, num_dopants * 4:],
                           anchor[:, 2:]], -1)
  score = t_planner.planner_scores(
      _t(single), rate_fn=t_rates.simple_canonical_rates, dwell_seconds=5.0,
      candidates=cand)
  top2 = torch.topk(score, 2, dim=-1).values.numpy()
  k_want = np.argmin(np.linalg.norm(
      cand[None] - want[:, None] * 2 * BOND, axis=-1), axis=-1)
  np.testing.assert_allclose(score.numpy()[np.arange(32), k_want], top2[:, 0],
                             atol=1e-5)
  clear = (top2[:, 0] - top2[:, 1]) > 1e-5
  assert clear.sum() >= 16
  np.testing.assert_allclose(got[clear], want[clear], atol=1e-4)
  agent = t_planner.MultiDopantPlannerAgent(
      rate_fn=t_rates.simple_canonical_rates, num_dopants=num_dopants,
      max_distance_angstroms=2 * BOND)
  assert torch.equal(agent.policy()(None, _t(obs)), _t(got))


@pytest.mark.parametrize('name,obs_dim', [
    ('multi_dopant_2', 8), ('multi_dopant_2_distilled', 14),
    ('multi_dopant_3', 12), ('multi_dopant_3_distilled', 18)])
def test_mlp_checkpoints_match_jax_eval_agent(name, obs_dim):
  path = os.path.join(t_eval_agent.MODEL_WEIGHTS_DIR, name)
  rng = np.random.default_rng(11)
  obs = rng.uniform(-12, 12, (64, obs_dim)).astype(np.float32)
  want = np.asarray(j_eval_agent.EvalAgent.load(path).policy()(
      None, jnp.asarray(obs)))
  model = t_eval_agent.load_policy(path, 'cpu')
  assert isinstance(model, t_eval_agent.MLPPolicy)
  got = t_eval_agent.mean_policy(model)(None, _t(obs)).numpy()
  assert got.shape == want.shape == (64, 2)
  # Two f32 tanh towers of width 256-512: 1e-5.
  np.testing.assert_allclose(got, want, atol=1e-5)
  assert np.abs(got).max() <= 1.0


def test_mlp_from_flax_with_per_dim_output_scale():
  rng = np.random.default_rng(12)
  widths = [10, 32, 16, 3]
  params = {
      f'Dense_{i}': {
          'kernel': rng.normal(size=(a, b)).astype(np.float32) * 0.3,
          'bias': rng.normal(size=(b,)).astype(np.float32) * 0.1}
      for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}
  scale = (2.84, 2.84, 1.0)
  module = j_eval_agent.MLPPolicy(hidden=(32, 16), action_dim=3,
                                  output_scale=scale)
  obs = rng.normal(size=(8, 10)).astype(np.float32)
  want = np.asarray(module.apply({'params': params}, jnp.asarray(obs)))
  model = t_eval_agent.mlp_from_flax(params, output_scale=scale)
  assert [m.out_features for m in model.hidden] == [32, 16]
  got = model(_t(obs)).detach().numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)


def test_load_policy_refuses_a_checkpoint_that_does_not_fit_its_arch(tmp_path):
  """The shipped multi_dopant_2 parameters under a policy.json that names
  other widths: the loader raises instead of building a wrong tower."""
  src = os.path.join(t_eval_agent.MODEL_WEIGHTS_DIR, 'multi_dopant_2')
  shutil.copy(os.path.join(src, 'policy.ckpt'), tmp_path / 'policy.ckpt')
  with open(os.path.join(src, 'policy.json')) as f:
    meta = json.load(f)
  meta['arch']['hidden'] = [128, 128]
  (tmp_path / 'policy.json').write_text(json.dumps(meta))
  with pytest.raises(ValueError, match='does not fit'):
    t_eval_agent.load_policy(str(tmp_path))


# --- registry and whole evals ------------------------------------------------


def test_registry_names_equal_jax_less_the_drift_entries():
  # The names equal the JAX registry's, all fourteen, drift entries
  # included, and each env is configured as the JAX one.
  want = list(j_registry.multi_dopant_experiment_names())
  assert len(want) == 14
  assert sorted(t_registry.multi_dopant_experiment_names()) == sorted(want)
  for name in want:
    t_exp = t_registry.create_multi_dopant_experiment(name)
    j_exp = j_registry.create_multi_dopant_experiment(name)
    assert t_exp.num_dopants == j_exp.num_dopants
    assert (t_exp.get_agent is None) == (j_exp.get_agent is None)
    t_envir = t_exp.make_env(2, device='cpu')
    j_envir = j_exp.make_env(2)
    for field in ('num_dopants', 'dwell_seconds', 'image_duration_seconds',
                  'fov_width', 'step_limit', 'sticky_goals', 'action_mode',
                  'max_distance_angstroms', 'observation_mode', 'anchor_order',
                  'image_size', 'window_capacity', 'noisy_images',
                  'drift_per_frame_angstroms', 'include_fov',
                  'max_kmc_events_per_step'):
      assert getattr(t_envir, field) == getattr(j_envir, field), (name, field)
    assert t_envir.lattice.num_atoms == j_envir.lattice.num_atoms
  with pytest.raises(ValueError, match='Unknown'):
    t_registry.create_multi_dopant_experiment(
        'multi_dopant_5_vision_planner_drift')


def test_evaluate_batched_reads_the_step_limit_of_either_env():
  exp = t_registry.create_multi_dopant_experiment('multi_dopant_2_random')
  envir = exp.make_env(3, step_limit=4, device='cpu')
  calls = []

  def policy(gen, obs):
    calls.append(obs.shape)
    return torch.zeros((3, 2))

  results = t_eval_lib.evaluate_batched(envir, policy, (0, 1, 2))
  assert len(calls) == 4 and calls[0] == (3, 8)
  assert [r.num_actions_taken for r in results] == [4, 4, 4]
  assert not any(r.reached_goal for r in results)


def test_multi_dopant_2_planner_tiny_eval_reaches_goals_in_both_packages():
  report = t_eval.main(t_eval.Args(
      experiment_name='multi_dopant_2_planner', eval_suite='tiny_eval',
      device='cpu'))
  assert report['aggregate']['average_num_times_reached_goal'] >= 0.9
  assert 5 < report['aggregate']['average_num_actions_taken'] < 60
  j_aggregate = j_eval.main(j_eval.Args(
      experiment_name='multi_dopant_2_planner', eval_suite='tiny_eval'))
  assert j_aggregate.average_num_times_reached_goal >= 0.9


@pytest.mark.parametrize('name,bar', [
    ('multi_dopant_2_distilled', 0.75), ('multi_dopant_3_planner', 0.9),
    ('multi_dopant_2_ppo', 0.5)])
def test_multi_dopant_tiny_evals_reach_goals(name, bar):
  report = t_eval.main(t_eval.Args(
      experiment_name=name, eval_suite='tiny_eval', device='cpu'))
  assert report['aggregate']['average_num_times_reached_goal'] >= bar
  assert report['aggregate']['evaluator'] == t_eval_lib.BATCHED_EVALUATOR


def test_random_policy_runs_and_eval_raises_without_cuda():
  report = t_eval.main(t_eval.Args(
      experiment_name='multi_dopant_4_random', eval_suite='tiny_eval',
      step_limit=5, device='cpu'))
  assert report['env_steps'] == 50
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      t_eval.main(t_eval.Args(experiment_name='multi_dopant_2_planner'))
