"""Port parity for the planner, the lattice-frame estimator, the vision
planner policy and the two planner evals.

Seeded numpy observations and synthetic probability maps (the
construction of tests/test_vision_planner.py, with known answers) go
through both packages on the CPU. Planner scores are compared
element-wise (1e-5); actions only where the best score leads the second
by more than 1e-5, since an argmax may break a rounding tie either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import eval as t_eval
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.agents import vision_planner as t_vp
from putting_dune_torch.env import env as t_env
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu.agents import planner as j_planner
from putting_dune_tpu.agents import vision_planner as j_vp

torch.set_num_threads(2)

BOND = 1.42
S = 128


def _t(x):
  return torch.from_numpy(np.array(x))


def _observations(seed, batch=32):
  """(B, 10) material-frame features: silicon, three neighbors at a random
  bond orientation, a goal a few bonds away."""
  rng = np.random.default_rng(seed)
  si = rng.uniform(-20, 20, (batch, 2))
  theta = rng.uniform(0, 2 * np.pi, (batch, 1))
  angles = theta + np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3])
  nbr = BOND * np.stack([np.cos(angles), np.sin(angles)], -1)
  goal = rng.uniform(-8, 8, (batch, 2))
  return np.concatenate([si, nbr.reshape(batch, 6), goal], -1).astype(
      np.float32)


def test_candidate_offsets_equal():
  for kwargs in ({}, {'max_radius': 2 * BOND},
                 {'num_radii': 4, 'num_angles': 12, 'min_radius': 0.5}):
    np.testing.assert_array_equal(
        t_planner.make_candidate_offsets(**kwargs),
        j_planner.make_candidate_offsets(**kwargs))
  assert t_planner.make_candidate_offsets().shape == (640, 2)


DWELL_GRID = np.linspace(0.5, 8.0, 6, dtype=np.float32)


@pytest.mark.parametrize('rate_name', ['simple_canonical_rates',
                                       'prior_rates'])
@pytest.mark.parametrize('kwargs', [
    {'dwell_seconds': 5.0},
    {'dwell_seconds': 1.5, 'lookahead_discount': 0.5},
    {'dwell_grid_seconds': DWELL_GRID},
    {'dwell_grid_seconds': DWELL_GRID, 'dwell_objective': 'per_frame',
     'lookahead_discount': 0.5},
], ids=['fixed', 'lookahead', 'grid_per_second', 'grid_per_frame'])
def test_planner_policy_matches_jax(rate_name, kwargs):
  obs = _observations(0)
  cand = t_planner.make_candidate_offsets()
  want = np.asarray(j_planner.planner_policy(
      None, jnp.asarray(obs), rate_fn=getattr(j_rates, rate_name),
      candidates=cand, **kwargs))
  t_kwargs = dict(rate_fn=getattr(t_rates, rate_name), candidates=cand,
                  **kwargs)
  score = t_planner.planner_scores(_t(obs), **t_kwargs)
  got = t_planner.planner_policy(None, _t(obs), **t_kwargs).numpy()
  grid = 'dwell_grid_seconds' in kwargs
  assert got.shape == want.shape == (32, 3 if grid else 2)
  assert score.shape == ((32, 640, 6) if grid else (32, 640))

  # The JAX action's score in the port's table equals the port's best
  # score: the two packages rank the candidates alike.
  flat = score.reshape(32, -1)
  top2 = torch.topk(flat, 2, dim=-1).values.numpy()
  k_want = np.argmin(
      np.linalg.norm(cand[None] - want[:, None, :2], axis=-1), axis=-1)
  if grid:
    span = DWELL_GRID[-1] - DWELL_GRID[0]
    d_want = np.rint(want[:, 2] * span / (DWELL_GRID[1] - DWELL_GRID[0]))
    idx = k_want * len(DWELL_GRID) + d_want.astype(np.int64)
  else:
    idx = k_want
  score_of_want = flat.numpy()[np.arange(32), idx]
  np.testing.assert_allclose(score_of_want, top2[:, 0], atol=1e-5)
  clear = (top2[:, 0] - top2[:, 1]) > 1e-5
  assert clear.sum() >= 16
  np.testing.assert_allclose(got[clear], want[clear], atol=1e-6)


def test_planner_scores_match_a_direct_jax_computation():
  """Element-wise scores for the fixed dwell: sum_i r_i/R (1 - exp(-R T))
  (dist_now - dist_next_i), from the JAX rate function."""
  obs = _observations(1, batch=8)
  cand = t_planner.make_candidate_offsets(num_radii=3, num_angles=8)
  got = t_planner.planner_scores(
      _t(obs), rate_fn=t_rates.simple_canonical_rates, dwell_seconds=5.0,
      candidates=cand).numpy()
  si, nbr, goal = obs[:, :2], obs[:, 2:8].reshape(8, 3, 2), obs[:, 8:]
  want = np.zeros((8, 24), np.float64)
  for k in range(24):
    r = np.asarray(j_rates.simple_canonical_rates(
        jnp.asarray(si), jnp.asarray(si[:, None] + nbr),
        jnp.asarray(si + cand[k]))).astype(np.float64)
    total = r.sum(-1)
    value = (np.linalg.norm(goal, axis=-1)[:, None]
             - np.linalg.norm(goal[:, None] - nbr, axis=-1))
    want[:, k] = ((r / total[:, None]) * value).sum(-1) * (
        1 - np.exp(-total * 5.0))
  np.testing.assert_allclose(got, want, atol=1e-5)


def test_planner_policy_rejects_unknown_objective():
  with pytest.raises(ValueError, match='dwell_objective'):
    t_planner.planner_policy(
        None, _t(_observations(0, 2)), rate_fn=t_rates.prior_rates,
        candidates=t_planner.make_candidate_offsets(),
        dwell_objective='per_hour')


def test_planner_agent_policy_matches_planner_policy():
  obs = _t(_observations(2, 4))
  agent = t_planner.PlannerAgent(
      rate_fn=t_rates.simple_canonical_rates, dwell_range_seconds=(1.0, 6.0),
      num_dwells=5)
  got = agent.policy()(None, obs)
  want = t_planner.planner_policy(
      None, obs, rate_fn=t_rates.simple_canonical_rates,
      candidates=t_planner.make_candidate_offsets(),
      dwell_grid_seconds=np.linspace(1.0, 6.0, 5, dtype=np.float32))
  assert got.shape == (4, 3)
  assert torch.equal(got, want)


# --- lattice frame ---------------------------------------------------------------


def _gaussian_blob(x, y, cx, cy, sigma=1.6):
  return np.exp(-0.5 * ((x - cx) ** 2 + (y - cy) ** 2) / sigma**2)


def _pixel_frame():
  xs = np.arange(S) + 0.5
  return np.tile(xs[None, :], (S, 1)), np.tile((S - xs)[:, None], (1, S))


def _synthetic_maps(si_xy, bond_px, theta0):
  """Si + two carbon shells in the math pixel frame (x right, y up; row 0
  is the image top)."""
  x, y = _pixel_frame()
  p_si = _gaussian_blob(x, y, si_xy[0], si_xy[1])
  p_c = np.zeros((S, S))
  for k in range(3):
    a = theta0 + 2 * np.pi * k / 3
    p_c += _gaussian_blob(
        x, y, si_xy[0] + bond_px * np.cos(a), si_xy[1] + bond_px * np.sin(a))
  for k in range(6):
    a = theta0 + np.pi / 3 * k + np.pi / 6
    rr = np.sqrt(3.0) * bond_px
    p_c += _gaussian_blob(
        x, y, si_xy[0] + rr * np.cos(a), si_xy[1] + rr * np.sin(a))
  return (p_si.astype(np.float32),
          np.clip(p_c, 0.0, 1.0).astype(np.float32))


def _full_honeycomb_maps(si_xy, bond_px, theta0):
  """Si + carbon maps for a full honeycomb sheet covering the image."""
  x, y = _pixel_frame()
  c, s = np.cos(theta0), np.sin(theta0)
  rot = np.array([[c, -s], [s, c]])
  a1 = rot @ (bond_px * np.array([1.5, np.sqrt(3) / 2]))
  a2 = rot @ (bond_px * np.array([1.5, -np.sqrt(3) / 2]))
  d = rot @ (bond_px * np.array([1.0, 0.0]))
  p_c = np.zeros((S, S))
  n = int(S / bond_px) + 2
  for n1 in range(-n, n + 1):
    for n2 in range(-n, n + 1):
      base = np.asarray(si_xy) + n1 * a1 + n2 * a2
      for site in (base, base + d):
        if np.allclose(site, si_xy):
          continue
        if -5 < site[0] < S + 5 and -5 < site[1] < S + 5:
          p_c += _gaussian_blob(x, y, site[0], site[1])
  p_si = _gaussian_blob(x, y, si_xy[0], si_xy[1])
  return (p_si.astype(np.float32),
          np.clip(p_c, 0.0, 1.0).astype(np.float32))


def _angle_error(theta, theta0):
  diff = (theta - theta0) % (2 * np.pi / 3)
  return np.minimum(diff, 2 * np.pi / 3 - diff)


@pytest.mark.parametrize('maps', ['shells', 'sheet'])
def test_estimate_lattice_frame_matches_jax_and_truth(maps):
  cases = [((61.3, 70.8), 7.0, 0.1), ((61.3, 70.8), 12.0, 0.9),
           ((50.2, 66.1), 7.0, -1.2), ((63.0, 67.0), 8.5, 0.45),
           ((70.5, 58.4), 14.0, 2.0), ((63.0, 67.0), 6.0, 0.45)]
  make = _synthetic_maps if maps == 'shells' else _full_honeycomb_maps
  pairs = [make(*case) for case in cases]
  p_si = np.stack([p[0] for p in pairs])
  p_c = np.stack([p[1] for p in pairs])
  want = [np.asarray(a) for a in j_vp.estimate_lattice_frame(
      jnp.asarray(p_si), jnp.asarray(p_c))]
  got = [a.numpy() for a in t_vp.estimate_lattice_frame(_t(p_si), _t(p_c))]
  assert got[0].shape == (6, 2) and got[1].shape == got[2].shape == (6,)
  # Against the JAX package.
  np.testing.assert_allclose(got[0], want[0], atol=1e-3)
  np.testing.assert_allclose(got[1], want[1], atol=1e-3)
  assert _angle_error(got[2], want[2]).max() <= 1e-4
  # Against the truth the maps were built from.
  truth_xy = np.array([c[0] for c in cases])
  truth_bond = np.array([c[1] for c in cases])
  truth_theta = np.array([c[2] for c in cases])
  np.testing.assert_allclose(got[0], truth_xy, atol=1.0)
  assert np.abs(got[1] - truth_bond).max() < 1.0
  assert _angle_error(got[2], truth_theta).max() < np.deg2rad(3.0)


def test_snap_to_honeycomb_matches_jax_and_snaps_exact_sites():
  rng = np.random.default_rng(5)
  theta0 = rng.uniform(-1, 1, 16).astype(np.float32)
  e = lambda a: BOND * np.stack([np.cos(a), np.sin(a)], -1)  # noqa: E731
  b0, b1, b2 = e(theta0), e(theta0 + 2 * np.pi / 3), e(theta0 + 4 * np.pi / 3)
  m = rng.integers(-3, 4, (16, 1))
  n = rng.integers(-3, 4, (16, 1))
  sub = rng.integers(0, 2, (16, 1))
  exact = (m * (b0 - b1) + n * (b0 - b2) + sub * b0).astype(np.float32)
  delta = exact + rng.normal(scale=0.15, size=(16, 2)).astype(np.float32)
  want = np.asarray(j_vp.snap_to_honeycomb(jnp.asarray(delta),
                                           jnp.asarray(theta0)))
  got = t_vp.snap_to_honeycomb(_t(delta), _t(theta0)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)
  np.testing.assert_allclose(got, exact, atol=1e-4)


def _stub_detector_maps(batch_cases):
  """Logits whose softmax is (nearly) the synthetic maps."""
  logits = []
  for case in batch_cases:
    p_si, p_c = _synthetic_maps(*case)
    p_c = np.clip(p_c, 0, 1 - p_si) * 0.98
    p_si = p_si * 0.98
    p_bg = np.clip(1 - p_si - p_c, 1e-4, 1)
    logits.append(np.log(np.clip(np.stack([p_bg, p_c, p_si], -1), 1e-4, 1)))
  return np.stack(logits).astype(np.float32)


def test_vision_planner_policy_with_stub_detector_matches_jax():
  cases = [((61.3, 70.8), 9.0, 0.1), ((64.0, 64.0), 12.0, 0.9),
           ((58.0, 70.0), 7.0, -1.2), ((66.0, 60.0), 10.0, 2.4)]
  logits = _stub_detector_maps(cases)
  rng = np.random.default_rng(7)
  goal = rng.uniform(-6, 6, (4, 2)).astype(np.float32)
  image = np.zeros((4, S, S, 1), np.float32)
  cand = t_planner.make_candidate_offsets(max_radius=2 * BOND)
  kwargs = dict(dwell_seconds=5.0, max_distance_angstroms=2 * BOND,
                candidates=cand)
  want = np.asarray(j_vp.vision_planner_policy(
      None, {'image': jnp.asarray(image),
             'goal_delta_angstroms': jnp.asarray(goal)},
      detector_fn=lambda img: jnp.asarray(logits),
      rate_fn=j_rates.simple_canonical_rates, **kwargs))
  got = t_vp.vision_planner_policy(
      None, {'image': _t(image), 'goal_delta_angstroms': _t(goal)},
      detector_fn=lambda img: _t(logits),
      rate_fn=t_rates.simple_canonical_rates, **kwargs).numpy()
  assert got.shape == (4, 2)
  assert np.abs(got).max() <= 1.0 + 1e-6  # units of max_distance
  np.testing.assert_allclose(got, want, atol=1e-5)
  # And against the truth: the beam points at the goalward neighbor.
  for (_, _, theta0), g, a in zip(cases, goal, got):
    angles = theta0 + np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3])
    nbrs = BOND * np.stack([np.cos(angles), np.sin(angles)], -1)
    goalward = nbrs[np.argmin(np.linalg.norm(nbrs - g, axis=-1))]
    beam = a * 2 * BOND
    assert np.linalg.norm(beam - goalward) < 0.6 * BOND

  snapped = t_vp.vision_planner_policy_from_probs(
      torch.softmax(_t(logits), -1), _t(goal),
      rate_fn=t_rates.simple_canonical_rates, snap_goal_to_lattice=True,
      **kwargs)
  want_snapped = np.asarray(j_vp.vision_planner_policy_from_probs(
      jnp.asarray(np.asarray(torch.softmax(_t(logits), -1))),
      jnp.asarray(goal), rate_fn=j_rates.simple_canonical_rates,
      snap_goal_to_lattice=True, **kwargs))
  np.testing.assert_allclose(snapped.numpy(), want_snapped, atol=1e-5)


# --- registry and eval ---------------------------------------------------------


def test_registry_names_and_compositions():
  names = t_registry.eval_experiment_names()
  assert 'planner_simple_rates' in names
  assert 'vision_planner_simple_rates' in names
  vision = t_registry.create_eval_experiment('vision_planner_simple_rates')
  parts = vision.get_adapters_and_goal()
  assert parts.feature_constructor.image_size == 256
  assert parts.action_adapter.min_dwell_seconds == 5.0
  assert parts.action_adapter.max_dwell_seconds == 5.0
  assert parts.action_adapter.max_distance_angstroms == pytest.approx(
      2 * BOND)
  planner = t_registry.create_eval_experiment('planner_simple_rates')
  parts = planner.get_adapters_and_goal()
  assert parts.action_adapter.min_dwell_seconds == 5.0
  agent = planner.get_policy(parts, 'cpu')
  assert isinstance(agent, t_planner.PlannerAgent)
  assert agent.rate_fn is t_rates.simple_canonical_rates
  assert agent.dwell_seconds == 5.0 and agent.dwell_range_seconds is None
  # eval.py turns agents into policies and leaves policies alone.
  assert callable(t_eval.policy_for_agent(agent))
  marker = lambda gen, obs: obs  # noqa: E731
  assert t_eval.policy_for_agent(marker) is marker


def test_vision_planner_two_env_steps_on_cpu():
  exp = t_registry.create_eval_experiment('vision_planner_simple_rates')
  parts = exp.get_adapters_and_goal()
  agent = exp.get_policy(parts, 'cpu')
  assert isinstance(agent, t_vp.VisionPlannerAgent)
  assert agent.dwell_seconds == 5.0
  policy = t_eval.policy_for_agent(agent)
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=2,
      image_size=256, device='cpu')
  gen = t_env.make_generator(0, torch.device('cpu'))
  with torch.inference_mode():
    state, ts = env.reset(gen)
    assert ts.observation['image'].shape == (2, 256, 256, 1)
    for _ in range(2):
      action = policy(gen, ts.observation)
      assert action.shape == (2, 2)
      assert bool(torch.isfinite(action).all())
      assert float(action.abs().max()) <= 1.0 + 1e-6
      state, ts = env.step(state, action, gen)
  assert bool(torch.isfinite(ts.observation['image']).all())


@pytest.mark.slow
def test_vision_planner_tiny_eval_reaches_goals_on_cpu():
  report = t_eval.main(t_eval.Args(
      experiment_name='vision_planner_simple_rates', eval_suite='tiny_eval',
      image_size=256, device='cpu'))
  agg = report['aggregate']
  assert agg['average_num_times_reached_goal'] >= 0.9
  assert agg['average_num_actions_taken'] < 20


def test_planner_simple_rates_tiny_eval_reaches_every_goal():
  report = t_eval.main(t_eval.Args(
      experiment_name='planner_simple_rates', eval_suite='tiny_eval',
      device='cpu'))
  agg = report['aggregate']
  assert agg['average_num_times_reached_goal'] == 1.0
  # The greedy controller takes ~9-10 actions on this suite.
  assert agg['average_num_actions_taken'] < 12
