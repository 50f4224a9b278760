"""The port's multi-dopant vision planner against the JAX package, on the
CPU: `extract_peaks`, the D-dopant policy core (also with `live` and
`snap_goal_to_lattice`), the whole pixels-to-action policy behind a stub
detector, and the registry experiment for two env steps in both packages.
Inputs are synthetic maps made with numpy; tolerances are stated at each
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import eval as t_eval
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.agents import vision_planner as t_vp
from putting_dune_torch.env import env as t_env
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu.agents import vision_planner as j_vp
from putting_dune_tpu.experiments import registry as j_registry

torch.set_num_threads(2)

BOND = 1.42
S = 128


def _t(x):
  return torch.from_numpy(np.array(x))


def _blob(x, y, cx, cy, sigma=1.6):
  return np.exp(-0.5 * ((x - cx) ** 2 + (y - cy) ** 2) / sigma**2)


def _pixel_grids():
  xs = np.arange(S) + 0.5
  return np.tile(xs[None, :], (S, 1)), np.tile((S - xs)[:, None], (1, S))


def _blob_maps(truths, heights=None):
  """(B, S, S) maps with one blob per truth point; heights order them."""
  x, y = _pixel_grids()
  maps = []
  for b, truth in enumerate(truths):
    h = heights[b] if heights is not None else np.ones(len(truth))
    maps.append(sum(hk * _blob(x, y, cx, cy)
                    for hk, (cx, cy) in zip(h, truth)))
  return np.stack(maps).astype(np.float32)


@pytest.mark.parametrize('case', ['separated', 'close_pair', 'four'])
def test_extract_peaks_matches_jax_and_truth(case):
  if case == 'separated':
    truths = [[[40.3, 80.6], [75.9, 30.2], [100.4, 90.8]],
              [[20.7, 25.1], [64.2, 64.9], [110.3, 40.5]]]
    heights = [[1.0, 0.9, 0.8], [0.7, 1.0, 0.85]]
    sep, tol = 8.0, 0.5
  elif case == 'close_pair':
    # Two blobs one suppression radius apart stay distinct.
    truths = [[[60.0, 60.0], [69.0, 62.0]], [[30.5, 90.5], [36.0, 97.5]]]
    heights = [[1.0, 0.9], [0.9, 1.0]]
    sep, tol = 8.0, 1.0
  else:
    truths = [[[20.2, 20.9], [100.1, 22.2], [24.4, 101.0], [99.0, 104.6]]]
    heights = [[0.6, 0.7, 0.8, 0.9]]
    sep, tol = 6.0, 0.5
  p = _blob_maps(truths, heights)
  k = len(truths[0])
  want = np.asarray(j_vp.extract_peaks(jnp.asarray(p), k, sep))
  got = t_vp.extract_peaks(_t(p), k, sep).numpy()
  assert got.shape == want.shape == (len(truths), k, 2)
  # Same argmax pixels, same f32 soft-argmax: 1e-4 pixels.
  np.testing.assert_allclose(got, want, atol=1e-4)
  for b, truth in enumerate(truths):
    # Extraction order is descending peak height.
    order = np.argsort(-np.asarray(heights[b]))
    np.testing.assert_allclose(got[b], np.asarray(truth)[order], atol=tol)


def test_extract_peaks_clamps_negative_maps_and_sharpens():
  p = _blob_maps([[[50.0, 50.0], [90.0, 70.0]]], [[1.0, 0.8]]) - 0.05
  want = np.asarray(j_vp.extract_peaks(jnp.asarray(p), 2, 8.0, sharpen=2.0))
  got = t_vp.extract_peaks(_t(p), 2, 8.0, sharpen=2.0).numpy()
  np.testing.assert_allclose(got, want, atol=1e-4)
  assert np.isfinite(got).all()


def _multi_si_honeycomb(si_list, bond_px, theta0):
  """Full honeycomb maps with len(si_list) silicon sites (the first one
  on the A sublattice: neighbors at theta0 + 120k degrees)."""
  x, y = _pixel_grids()
  c, s = np.cos(theta0), np.sin(theta0)
  rot = np.array([[c, -s], [s, c]])
  a1 = rot @ (bond_px * np.array([1.5, np.sqrt(3) / 2]))
  a2 = rot @ (bond_px * np.array([1.5, -np.sqrt(3) / 2]))
  d = rot @ (bond_px * np.array([1.0, 0.0]))
  origin = np.asarray(si_list[0])
  p_c = np.zeros((S, S))
  p_si = np.zeros((S, S))
  n = int(S / bond_px) + 2
  for n1 in range(-n, n + 1):
    for n2 in range(-n, n + 1):
      base = origin + n1 * a1 + n2 * a2
      for site in (base, base + d):
        if not (-5 < site[0] < S + 5 and -5 < site[1] < S + 5):
          continue
        if any(np.linalg.norm(site - np.asarray(sxy)) < 0.25
               for sxy in si_list):
          p_si += _blob(x, y, site[0], site[1])
        else:
          p_c += _blob(x, y, site[0], site[1])
  return np.clip(p_si, 0, 1), np.clip(p_c, 0, 1)


def _scenes():
  """Three two-dopant scenes: (probs (3, S, S, 3), deltas (3, 2, 2)
  position-ordered, theta0s). In scene 1 the first dopant is latched."""
  probs, deltas, thetas = [], [], []
  rng = np.random.default_rng(3)
  for i, (theta0, bond_px) in enumerate([(0.15, 9.0), (-0.8, 9.0),
                                         (0.6, 11.0)]):
    c, s = np.cos(theta0), np.sin(theta0)
    rot = np.array([[c, -s], [s, c]])
    a1 = rot @ (bond_px * np.array([1.5, np.sqrt(3) / 2]))
    d = rot @ (bond_px * np.array([1.0, 0.0]))
    si_a = np.array([52.0, 61.0])
    si_b = si_a + 2 * a1 + d
    p_si, p_c = _multi_si_honeycomb([si_a, si_b], bond_px, theta0)
    p_bg = np.clip(1.0 - p_si - p_c, 1e-6, 1.0)
    maps = np.stack([p_bg, np.maximum(p_c, 1e-6), np.maximum(p_si, 1e-6)], -1)
    probs.append(maps / maps.sum(-1, keepdims=True))
    # Goal deltas in position order (x-major): A first when it lies left.
    goal = rng.uniform(-6, 6, (2, 2))
    if i == 1:
      first = 0 if si_a[0] < si_b[0] else 1
      goal[first] = 0.0  # latched: the other dopant is the anchor
    deltas.append(goal)
    thetas.append(theta0)
  return (np.stack(probs).astype(np.float32),
          np.stack(deltas).astype(np.float32), np.asarray(thetas))


@pytest.mark.parametrize('variant', ['plain', 'live', 'snap'])
def test_multi_dopant_policy_from_probs_matches_jax(variant):
  probs, deltas, _ = _scenes()
  cand = t_planner.make_candidate_offsets(max_radius=2 * BOND)
  kwargs = dict(num_dopants=2, dwell_seconds=5.0,
                max_distance_angstroms=2 * BOND, candidates=cand,
                min_separation_px=8.0)
  j_extra, t_extra = {}, {}
  if variant == 'live':
    live = np.array([[False, True], [True, True], [True, False]])
    j_extra, t_extra = {'live': jnp.asarray(live)}, {'live': _t(live)}
  elif variant == 'snap':
    j_extra = t_extra = {'snap_goal_to_lattice': True}
  want = np.asarray(j_vp.multi_dopant_vision_planner_policy_from_probs(
      jnp.asarray(probs), jnp.asarray(deltas),
      rate_fn=j_rates.simple_canonical_rates, **kwargs, **j_extra))
  got = t_vp.multi_dopant_vision_planner_policy_from_probs(
      _t(probs), _t(deltas), rate_fn=t_rates.simple_canonical_rates,
      **kwargs, **t_extra).numpy()
  assert got.shape == want.shape == (3, 2)
  assert np.isfinite(got).all() and np.abs(got).max() <= 1.0 + 1e-6
  # The actions are candidates of one grid: either the same candidate
  # (1e-4) or, at a near tie of the two best scores, a neighbouring one.
  same = np.abs(got - want).max(-1) <= 1e-4
  assert same.sum() >= 2, (got, want)
  assert np.abs(got - want).max() <= 0.12


def test_multi_dopant_vision_policy_with_stub_detector_matches_jax_and_truth():
  probs, deltas, thetas = _scenes()
  logits = np.log(probs)
  image = np.zeros((3, S, S, 1), np.float32)
  cand = t_planner.make_candidate_offsets(max_radius=2 * BOND)
  kwargs = dict(num_dopants=2, dwell_seconds=5.0,
                max_distance_angstroms=2 * BOND, candidates=cand,
                min_separation_px=8.0)
  want = np.asarray(j_vp.multi_dopant_vision_planner_policy(
      None, {'image': jnp.asarray(image),
             'goal_delta_angstroms': jnp.asarray(deltas.reshape(3, 4))},
      detector_fn=lambda img: jnp.asarray(logits),
      rate_fn=j_rates.simple_canonical_rates, **kwargs))
  got = t_vp.multi_dopant_vision_planner_policy(
      None, {'image': _t(image),
             'goal_delta_angstroms': _t(deltas.reshape(3, 4))},
      detector_fn=lambda img: _t(logits),
      rate_fn=t_rates.simple_canonical_rates, **kwargs).numpy()
  same = np.abs(got - want).max(-1) <= 1e-4
  assert same.sum() >= 2 and np.abs(got - want).max() <= 0.12
  # Against the planner on the anchor's true geometry: the anchor is the
  # first dopant with a live delta; both sublattices' neighbor sets are
  # theta0 + 60 k degrees, which the third harmonic cannot tell apart from
  # the goalward choice the planner makes.
  for b in range(3):
    pick = int(np.argmax(np.linalg.norm(deltas[b], axis=-1) > 1e-6))
    beam = got[b] * 2 * BOND
    toward = deltas[b, pick] / np.linalg.norm(deltas[b, pick])
    assert beam @ toward > 0.0, (b, beam, deltas[b, pick])


def test_agent_class_wraps_the_policy():
  probs, deltas, _ = _scenes()
  logits = _t(np.log(probs))
  agent = t_vp.MultiDopantVisionPlannerAgent.__new__(
      t_vp.MultiDopantVisionPlannerAgent)
  agent.rate_fn = t_rates.simple_canonical_rates
  agent.num_dopants = 2
  agent.dwell_seconds = 5.0
  agent.max_distance_angstroms = 2 * BOND
  agent.min_separation_px = 8.0
  agent._detector_fn = lambda img: logits
  agent._candidates = t_planner.make_candidate_offsets(max_radius=2 * BOND)
  obs = {'image': torch.zeros((3, S, S, 1)),
         'goal_delta_angstroms': _t(deltas.reshape(3, 4))}
  want = t_vp.multi_dopant_vision_planner_policy(
      None, obs, detector_fn=agent._detector_fn, rate_fn=agent.rate_fn,
      num_dopants=2, dwell_seconds=5.0, max_distance_angstroms=2 * BOND,
      candidates=agent._candidates, min_separation_px=8.0)
  assert torch.equal(agent.policy()(None, obs), want)


def test_multi_dopant_2_vision_planner_two_env_steps_in_both_packages():
  name = 'multi_dopant_2_vision_planner'
  t_exp = t_registry.create_multi_dopant_experiment(name)
  envir = t_exp.make_env(2, step_limit=50, device='cpu')
  assert (envir.observation_mode, envir.anchor_order, envir.image_size) == (
      'image', 'position', 256)
  policy = t_eval.policy_for_agent(t_exp.get_agent('cpu'))
  gen = t_env.make_generator(0, 'cpu')
  with torch.inference_mode():
    state, ts = envir.reset(gen)
    for _ in range(2):
      action = policy(gen, ts.observation)
      assert action.shape == (2, 2)
      assert bool(torch.isfinite(action).all())
      assert float(action.abs().max()) <= 1.0 + 1e-6
      state, ts = envir.step(state, action, gen)
  assert ts.observation['image'].shape == (2, 256, 256, 1)
  assert state.steps.tolist() == [2, 2]

  j_exp = j_registry.create_multi_dopant_experiment(name)
  j_envir = j_exp.make_env(2, step_limit=50)
  j_policy = j_exp.get_agent(None, None).policy()
  j_state, j_ts = j_envir.reset(jax.random.PRNGKey(0))
  key = jax.random.PRNGKey(1)
  for _ in range(2):
    j_action = np.asarray(j_policy(None, j_ts.observation))
    assert np.isfinite(j_action).all() and np.abs(j_action).max() <= 1 + 1e-6
    key, k = jax.random.split(key)
    j_state, j_ts = j_envir.step(j_state, jnp.asarray(j_action), k)
  assert j_ts.observation['image'].shape == (2, 256, 256, 1)


def test_shipped_detector_peaks_lie_on_the_env_dopants():
  """On the port's own 256^2 multi-dopant frames every extracted silicon
  peak lies nearer to a true dopant than a bond (14.5 pixels at 10.24
  pixels per A): the detector paints a plateau several pixels wide around
  each dopant, the hard argmax lands anywhere on it and the refinement
  disk has radius 3. The JAX package on its own frames shows the same
  spread (up to 11.5 pixels over 8 frames, and 2 of 3 dopants found in
  some), since a wide plateau can yield two peaks."""
  exp = t_registry.create_multi_dopant_experiment(
      'multi_dopant_3_vision_planner')
  envir = exp.make_env(4, device='cpu')
  gen = t_env.make_generator(5, 'cpu')
  with torch.inference_mode():
    state, ts = envir.reset(gen)
    detector = t_vp.load_shipped_detector(device='cpu')
    probs = torch.softmax(detector(ts.observation['image']), dim=-1)
    peaks = t_vp.extract_peaks(probs[..., 2], 3, 6.0)
  si = envir._si_positions(state)  # (B, D, 2) material frame
  scale = 256.0 / envir.fov_width
  truth_px = (si - state.fov_lower[:, None, :]) * scale  # x right, y up
  dist = torch.linalg.vector_norm(
      peaks[:, :, None, :] - truth_px[:, None, :, :], dim=-1)  # (B, P, D)
  bond_px = BOND * scale
  assert float(dist.amin(dim=-1).max()) < bond_px, dist
  # At least two of the three dopants are found in every frame.
  found = (dist < bond_px).any(dim=1).sum(dim=-1)
  assert int(found.min()) >= 2, found
