"""Public names of the JAX package that the port gained with the perception
training slice, each against the JAX package on the CPU: the
nearest-neighbour queries, the centred canonical sheet, `as_eval_agent`,
`get_mlp_fn`, `tree_stack`, `RateFunctionProtocol`, the seven stage-wise
noise operators (in law, KS at p > 1e-3, as the fused chain is held) and
`render_stem_image(noise_backend=)`, OpenCV's bilinear resize, and the
profiling helpers.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from putting_dune_torch import geometry as t_geometry
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch import simulator as t_simulator
from putting_dune_torch.agents import ppo as t_ppo
from putting_dune_torch.imaging import morphology as t_morphology
from putting_dune_torch.imaging import noise as t_noise
from putting_dune_torch.imaging import render as t_render
from putting_dune_torch.rate_learning import model as t_rl_model
from putting_dune_torch.rate_learning import train as t_rl_train
from putting_dune_torch.utils import profiling as t_profiling
from putting_dune_tpu import geometry as j_geometry
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import run_helpers as j_run_helpers
from putting_dune_tpu.agents import ppo as j_ppo
from putting_dune_tpu.experiments import registry as j_registry
from putting_dune_tpu.imaging import noise as j_noise
from putting_dune_tpu.rate_learning import model as j_rl_model
from putting_dune_tpu.rate_learning import train as j_rl_train

torch.set_num_threads(4)
P_MIN = 1e-3


# --- nearest neighbours ---------------------------------------------------------


@pytest.mark.parametrize('include_self', [False, True])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('single', [False, True])
def test_nearest_neighbors_equal_jax(include_self, masked, single):
  # The lattice: exact ties in distance, which must break the same way.
  pts = t_lattice.canonical_graphene_positions(8).astype(np.float32)
  query = pts[13] if single else pts[[0, 13, 30, 44]]
  mask = np.arange(len(pts)) % 5 != 2 if masked else None
  kw = dict(include_self=include_self)
  want = j_geometry.nearest_neighbors(
      jnp.asarray(pts), jnp.asarray(query), 5,
      valid_mask=None if mask is None else jnp.asarray(mask), **kw)
  got = t_geometry.nearest_neighbors(
      torch.from_numpy(pts), torch.from_numpy(query), 5,
      valid_mask=None if mask is None else torch.from_numpy(mask), **kw)
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
  want3 = j_geometry.nearest_neighbors3(jnp.asarray(pts), jnp.asarray(query),
                                        **kw)
  got3 = t_geometry.nearest_neighbors3(torch.from_numpy(pts),
                                       torch.from_numpy(query), **kw)
  np.testing.assert_array_equal(got3[1].numpy(), np.asarray(want3[1]))


def test_canonical_graphene_with_centered_silicon_equals_jax():
  for cols in (4, 10):
    want = j_lattice.canonical_graphene_with_centered_silicon(cols)
    got = t_lattice.canonical_graphene_with_centered_silicon(cols)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32 and (got[1] == 14).sum() == 1


# --- agents and the rate learner's helpers ----------------------------------------


@pytest.mark.parametrize('name', ['relative_simple_rates',
                                  'relative_simple_rates_from_images'])
def test_as_eval_agent_acts_as_jax(name):
  exp = t_registry.create_train_experiment(name)
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=3,
      device='cpu', image_size=32)
  config = t_ppo.PPOConfig(hidden=(16,), conv_features=(4, 8))
  model = t_ppo.PPOTrainer(env, config).init_carry(1).model
  agent = t_ppo.as_eval_agent(model, env, config)
  j_exp = j_registry.create_train_experiment(name)
  j_env = j_run_helpers.create_batched_env(
      j_exp.get_adapters_and_goal, j_exp.get_simulator_config, batch_size=3,
      image_size=32)
  j_agent = j_ppo.as_eval_agent(
      jax.tree_util.tree_map(jnp.asarray, t_ppo.actor_critic_to_flax(model)),
      j_env, j_ppo.PPOConfig(hidden=(16,), conv_features=(4, 8)))
  _, ts = env.reset(torch.Generator().manual_seed(0))
  obs = ts.observation
  with torch.no_grad():
    got = agent.policy()(None, obs).numpy()
  j_obs = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), obs)
  want = np.asarray(j_agent.policy()(None, j_obs))
  np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('batchnorm', [True, False])
def test_get_mlp_fn_matches_jax(batchnorm):
  x = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
  j_init, j_apply = j_rl_model.get_mlp_fn((8, 8), batchnorm=batchnorm)
  params, state = j_init(jax.random.PRNGKey(0), jnp.asarray(x))
  params, state = jax.device_get(params), jax.device_get(state)
  t_init, t_apply = t_rl_model.get_mlp_fn((8, 8), batchnorm=batchnorm)
  t_params, t_state = t_init(torch.Generator().manual_seed(0),
                             torch.from_numpy(x))
  assert jax.tree_util.tree_map(np.shape, t_params) == (
      jax.tree_util.tree_map(np.shape, params))
  for training in (True, False):
    want, want_state = j_apply(params, state, jax.random.PRNGKey(1),
                               jnp.asarray(x), training)
    got, got_state = t_apply(params, state, None, torch.from_numpy(x),
                             training)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for (_, a), (_, b) in zip(
        sorted(jax.tree_util.tree_leaves_with_path(got_state), key=str),
        sorted(jax.tree_util.tree_leaves_with_path(
            jax.device_get(want_state)), key=str)):
      np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
  one, _ = t_apply(params, state, None, torch.from_numpy(x[0]), False)
  assert one.shape == (4,)


def test_tree_stack_equals_jax():
  trees = [{'a': {'w': np.full((2, 3), i, np.float32)}, 'b': np.arange(i, i + 2)}
           for i in range(3)]
  want = jax.device_get(j_rl_train.tree_stack(trees))
  got = t_rl_train.tree_stack(trees)
  np.testing.assert_array_equal(got['a']['w'], want['a']['w'])
  np.testing.assert_array_equal(got['b'], want['b'])
  stacked = t_rl_train.tree_stack([{'w': torch.ones(2) * i} for i in range(4)])
  assert stacked['w'].shape == (4, 2) and float(stacked['w'][3, 0]) == 3.0


def test_rate_functions_satisfy_the_protocol():
  def law(si_pos, neighbor_pos, beam_pos) -> torch.Tensor:
    return t_rates.simple_canonical_rates(si_pos, neighbor_pos, beam_pos)

  fn: t_rates.RateFunctionProtocol = law
  si = torch.zeros((2, 2))
  nbr = torch.ones((2, 3, 2))
  assert fn(si, nbr, si).shape == (2, 3)


# --- the stage-wise noise operators -----------------------------------------------
#
# A stage that max-normalizes scales a whole frame by one random number, so
# its pixels are not independent draws: the laws are compared over frames,
# 48 copies of one clean frame, by KS on each frame's mean and standard
# deviation (and pixel by pixel where a stage does not normalize).

FRAMES = 48


def _frames(size=64):
  frame = np.random.default_rng(3).random((size, size)).astype(np.float32)
  return np.repeat(frame[None], FRAMES, axis=0)


def _ks(a, b):
  return scipy.stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue


def _assert_frames_in_law(want, got, label):
  for stat in (lambda x: x.mean(axis=(1, 2)), lambda x: x.std(axis=(1, 2))):
    p = _ks(stat(want), stat(got))
    assert p > P_MIN, (label, p)


STAGES = [
    ('apply_poisson_noise', 3.0), ('apply_poisson_noise', 200.0),
    ('apply_jitter', 2.0), ('apply_salt_and_pepper', 0.1),
    ('apply_uniform_noise', 0.2), ('apply_exponential_noise', 0.05),
    ('apply_gaussian_noise', 1e-3),
]


@pytest.mark.parametrize('stage,value', STAGES)
def test_noise_stage_matches_jax_in_law(stage, value):
  image = _frames()
  p = np.full(FRAMES, value, np.float32)
  want = np.asarray(getattr(j_noise, stage)(
      jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(p)))
  got = getattr(t_noise, stage)(torch.Generator().manual_seed(0),
                                torch.from_numpy(image),
                                torch.from_numpy(p)).numpy()
  assert got.shape == want.shape and got.dtype == want.dtype
  _assert_frames_in_law(want, got, stage)
  if stage == 'apply_jitter':
    # Each row's shift: the roll that maps the clean row onto it.
    def shifts(out):
      rolls = np.stack([np.roll(image[0], s, axis=-1) for s in range(64)])
      err = np.abs(rolls[None] - out[:, None]).sum(-1)  # (B, S, H)
      return err.argmin(1)
    assert _ks(shifts(want), shifts(got)) > P_MIN
  elif stage in ('apply_salt_and_pepper', 'apply_gaussian_noise'):
    assert _ks(want - image, got - image) > P_MIN


def test_poisson_exact_and_contrast():
  image = _frames()
  p = np.full(FRAMES, 3.0, np.float32)
  want = np.asarray(j_noise.apply_poisson_noise(
      jax.random.PRNGKey(1), jnp.asarray(image), jnp.asarray(p), exact=True))
  got = t_noise.apply_poisson_noise(
      torch.Generator().manual_seed(1), torch.from_numpy(image),
      torch.from_numpy(p), exact=True).numpy()
  _assert_frames_in_law(want, got, 'exact poisson')
  # Each frame's largest count: 1 / its least positive value.
  peak = lambda x: np.round(1.0 / np.where(x > 0, x, 9).min(axis=(1, 2)))  # noqa: E731
  assert _ks(peak(want), peak(got)) > P_MIN
  gamma = np.asarray([0.7, 1.0, 1.3, 2.0] * (FRAMES // 4), np.float32)
  np.testing.assert_allclose(
      t_noise.apply_contrast(torch.from_numpy(image - 0.1),
                             torch.from_numpy(gamma)).numpy(),
      np.asarray(j_noise.apply_contrast(jnp.asarray(image - 0.1),
                                        jnp.asarray(gamma))), rtol=1e-6)


def test_render_noise_backends_agree_in_law():
  """The stage-wise chain against the fused chain (its plain twin on the
  CPU) on copies of one rendered frame with one frame's parameters."""
  lattice = t_lattice.make_lattice(20, 'cpu')
  gen = torch.Generator().manual_seed(4)
  config = t_simulator.SimulatorConfig(image_size=64, noisy_images=True)
  state, obs = t_simulator.reset(gen, lattice, config=config, batch_size=1,
                                 return_window=True)
  index = torch.zeros(FRAMES, dtype=torch.long)
  pick = lambda tree: type(tree)(**{  # noqa: E731
      f.name: getattr(tree, f.name)[index]
      for f in dataclasses.fields(tree)})
  window, fov, imaging = pick(obs.window), pick(state.fov), pick(state.imaging)
  frames = {}
  for backend in t_render.NOISE_BACKENDS:
    frames[backend] = t_render.render_stem_image(
        torch.Generator().manual_seed(5), window, fov, imaging,
        image_size=64, noise_backend=backend, apply_clahe=False).numpy()
  _assert_frames_in_law(frames['fused'], frames['stages'], 'render')
  with pytest.raises(ValueError, match='noise_backend'):
    t_render.render_stem_image(gen, obs.window, state.fov, state.imaging,
                               image_size=64, noise_backend='xla')


# --- OpenCV's bilinear resize -----------------------------------------------------


@pytest.mark.parametrize('src,dst', [((100, 100), (128, 128)),
                                     ((1000, 1000), (128, 128)),
                                     ((131, 97), (128, 128)),
                                     ((128, 128), (37, 53)),
                                     ((513, 77), (129, 300)),
                                     ((5, 7), (13, 3))])
def test_resize_bilinear_equals_cv2(src, dst):
  image = np.random.default_rng(0).random(src).astype(np.float32)
  want = cv2.resize(image, dst[::-1], interpolation=cv2.INTER_LINEAR)
  got = t_morphology.resize_bilinear(image, *dst)
  assert got.dtype == np.float32 and got.shape == want.shape
  assert np.abs(got - want).max() <= 1e-6


# --- profiling ----------------------------------------------------------------------


def test_profiling_helpers(tmp_path):
  with t_profiling.trace(str(tmp_path)):
    torch.ones(8).sum()
  assert (tmp_path / 'trace.json').stat().st_size > 0
  meter = t_profiling.Throughput(warmup=1)
  assert meter.rate() == 0.0
  for _ in range(3):
    meter.tick(items=4)
  assert meter.rate() > 0
  out = {}
  with t_profiling.timed('x', out):
    pass
  assert out['x'] >= 0
