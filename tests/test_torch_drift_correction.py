"""The port's in-loop drift correction against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through
putting_dune_tpu/agents/drift_correction.py and its port in one process.
Everything here is deterministic, so it is held element-wise, with the
tolerance stated at each test: the phase correlation's FFTs differ in
their last bits between XLA's and PyTorch's CPU FFTs, so the inputs have a
clear correlation peak (a band-limited scene, or a honeycomb scene moved by
a known drift) and the sub-pixel shifts agree to 1e-3 px. The policies run
on a fixed 1x1 convolution as the detector in both packages, so no UNet
runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import rates as t_rates
from putting_dune_torch.agents import drift_correction as t_dc
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.agents import vision_planner as t_vp
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu.agents import drift_correction as j_dc
from putting_dune_tpu.agents import planner as j_planner
from putting_dune_tpu.agents import vision_planner as j_vp

torch.set_num_threads(2)

BOND = 1.42
S = 64


def _t(x):
  return torch.from_numpy(np.array(x))


def _smooth_random_image(rng, s):
  """Band-limited random image, so that correlation peaks are sharp."""
  f = np.fft.rfft2(rng.normal(size=(s, s)))
  ky = np.fft.fftfreq(s)[:, None]
  kx = np.fft.rfftfreq(s)[None, :]
  img = np.fft.irfft2(f * np.exp(-(kx**2 + ky**2) / (2 * 0.05**2)), s=(s, s))
  return (img - img.min()) / (img.max() - img.min())


def _fourier_shift(img, dr, dc):
  """img moved by (dr, dc) pixels, sub-pixel, periodic."""
  s = img.shape[0]
  ky = np.fft.fftfreq(s)[:, None]
  kx = np.fft.fftfreq(s)[None, :]
  phase = np.exp(-2j * np.pi * (ky * dr + kx * dc))
  return np.real(np.fft.ifft2(np.fft.fft2(img) * phase))


def _both(prev, cur, expected, radius):
  want = np.asarray(j_dc.estimate_content_shift_px(
      jnp.asarray(prev, jnp.float32), jnp.asarray(cur, jnp.float32),
      jnp.asarray(expected, jnp.float32), jnp.asarray(radius, jnp.float32)))
  got = t_dc.estimate_content_shift_px(
      _t(prev.astype(np.float32)), _t(cur.astype(np.float32)),
      _t(np.asarray(expected, np.float32)),
      _t(np.asarray(radius, np.float32))).numpy()
  return got, want


def test_estimator_integer_shifts_match_jax():
  rng = np.random.default_rng(0)
  base = _smooth_random_image(rng, S)
  shifts = np.array([[3, -5], [0, 0], [-7, 2], [10, 10], [-31, 17]])
  prev = np.stack([base] * len(shifts))
  cur = np.stack([np.roll(base, (r, c), axis=(0, 1)) for r, c in shifts])
  expected = np.zeros((len(shifts), 2))
  expected[-1] = [-30.0, 16.0]  # a shift that wraps past S/2
  got, want = _both(prev, cur, expected, np.full((len(shifts),), 16.0))
  # The same peak in both (1e-3 px, the FFTs' last bits), and the integer
  # branch recovered up to 10 px (the parabolic refinement of a
  # Hann-windowed peak carries a bias below 0.75 px there, as the JAX test
  # states; at half the frame the windows barely overlap and the bias
  # grows, in both packages alike).
  np.testing.assert_allclose(got, want, atol=1e-3)
  np.testing.assert_allclose(got[:4], shifts[:4], atol=0.75)
  assert np.abs(got[4] - expected[4]).max() <= 16.0


def test_estimator_subpixel_shifts_match_jax():
  rng = np.random.default_rng(1)
  base = _smooth_random_image(rng, S)
  shifts = rng.uniform(-4.0, 4.0, (6, 2))
  prev = np.stack([base] * len(shifts))
  cur = np.stack([_fourier_shift(base, r, c) for r, c in shifts])
  # Expectations off by up to a pixel, radius 3 px around them.
  expected = shifts + rng.uniform(-1.0, 1.0, shifts.shape)
  got, want = _both(prev, cur, expected, np.full((len(shifts),), 3.0))
  np.testing.assert_allclose(got, want, atol=1e-3)
  np.testing.assert_allclose(got, shifts, atol=0.5)


def test_estimator_window_resolves_the_lattice_alias_as_jax():
  """A periodic scene: the window around the expectation picks the right
  branch of the alias (JAX tests/test_drift_correction.py:47-66)."""
  x = jnp.arange(S)
  period = 16
  base = np.asarray(jnp.sin(2 * jnp.pi * x[:, None] / period)
                    * jnp.sin(2 * jnp.pi * x[None, :] / period))
  # The JAX test's own scene: four nonzero frequency bins; every other bin
  # of the normalised cross-power spectrum is rounding noise raised to
  # unit size, so the FFTs' last bits move its sub-pixel peak by ~1e-2 px
  # (0.05 here), and the frame-fixed Hann window pulls it toward the zero
  # shift's alias at 16 (the JAX test's own 0.75 px band holds).
  got, want = _both(base[None], np.roll(base, (18, 0), axis=(0, 1))[None],
                    np.array([[16.0, 0.0]]), np.array([4.0]))
  np.testing.assert_allclose(got, want, atol=0.05)
  np.testing.assert_allclose(got, [[18.0, 0.0]], atol=0.75)
  # With band-limited texture on the lattice the spectrum is full and the
  # packages agree to 1e-3 px. Shifts of one and two periods + 4 px, the
  # windows keeping out both the zero shift's aliases and the other
  # periods.
  textured = base + 0.2 * _smooth_random_image(np.random.default_rng(6), S)
  prev = np.stack([textured, textured])
  cur = np.stack([np.roll(textured, (20, 0), axis=(0, 1)),
                  np.roll(textured, (36, 0), axis=(0, 1))])
  got, want = _both(prev, cur, np.array([[20.5, 0.0], [36.5, 0.0]]),
                    np.array([3.0, 3.0]))
  np.testing.assert_allclose(got, want, atol=1e-3)
  # On the true branch: nearer the true shift than the aliases (+-16 px,
  # and the zero shift's 16 and 32). The window's bias grows with the
  # shift, in both packages alike (got == want above).
  np.testing.assert_allclose(got, [[20.0, 0.0], [36.0, 0.0]], atol=2.0)


def test_estimator_ties_and_the_window_clamp_match_jax():
  # Flat frames correlate to all zeros: every pixel of the window ties,
  # and both packages take the first index inside it. A radius below 1.5
  # px is clamped to 1.5, so a fractional expectation still has pixels.
  flat = np.full((3, S, S), 0.5)
  expected = np.array([[2.4, -3.6], [0.5, 0.5], [-40.2, 7.7]])
  got, want = _both(flat, flat, expected, np.array([0.1, 0.0, 6.0]))
  np.testing.assert_allclose(got, want, atol=1e-6)
  assert np.all(np.abs(got - expected).max(-1) <= 6.0 + 1e-4)


def _tracker_inputs(rng, batch=5):
  base = _smooth_random_image(rng, S)
  maps = np.stack([_fourier_shift(base, *rng.uniform(-3, 3, 2))
                   for _ in range(batch)]).astype(np.float32)
  prev_map = np.stack([base] * batch).astype(np.float32)
  ll = rng.uniform(-20, 20, (batch, 2)).astype(np.float32)
  width = rng.uniform(15, 30, (batch,)).astype(np.float32)
  ur = ll + width[:, None]
  prev_ll = (ll + rng.uniform(-0.6, 0.6, (batch, 2))).astype(np.float32)
  drift = rng.uniform(-2, 2, (batch, 2)).astype(np.float32)
  first = np.array([False, True, False, False, True])[:batch]
  goal = rng.uniform(-5, 5, (batch, 2)).astype(np.float32)
  return prev_map, maps, ll, ur, prev_ll, drift, first, goal


def test_drift_tracker_update_matches_jax():
  rng = np.random.default_rng(2)
  prev_map, maps, ll, ur, prev_ll, drift, first, goal = _tracker_inputs(rng)
  j_state = j_dc.DriftTracker(1.0).update(
      dict(prev_map=jnp.asarray(prev_map), prev_ll=jnp.asarray(prev_ll),
           drift=jnp.asarray(drift)),
      jnp.asarray(maps),
      {'fov_lower_left': jnp.asarray(ll), 'fov_upper_right': jnp.asarray(ur),
       'goal_delta_angstroms': jnp.asarray(goal)},
      jnp.asarray(first))
  t_state = t_dc.DriftTracker(1.0).update(
      dict(prev_map=_t(prev_map), prev_ll=_t(prev_ll), drift=_t(drift)),
      _t(maps),
      {'fov_lower_left': _t(ll), 'fov_upper_right': _t(ur),
       'goal_delta_angstroms': _t(goal)},
      _t(first))
  # 1e-3 px of shift is below 5e-4 A at these widths (30 A over 64 px).
  np.testing.assert_allclose(t_state['drift'].numpy(),
                             np.asarray(j_state['drift']), atol=5e-4)
  assert np.all(t_state['drift'].numpy()[first] == 0.0)
  assert np.abs(t_state['drift'].numpy()[~first]).max() > 0.1
  assert torch.equal(t_state['prev_map'], _t(maps))
  assert torch.equal(t_state['prev_ll'], _t(ll))
  init = t_dc.DriftTracker(1.0).init(
      _t(maps), {'fov_lower_left': _t(ll), 'goal_delta_angstroms': _t(goal)})
  assert float(init['drift'].abs().max()) == 0.0
  assert init['drift'].shape == (5, 2)


def test_drift_corrected_policy_matches_jax():
  rng = np.random.default_rng(4)
  prev_map, maps, ll, ur, prev_ll, drift, first, goal = _tracker_inputs(rng)
  seen = {}

  def j_base(key, obs):
    del key
    seen['jax'] = np.asarray(obs['goal_delta_angstroms'])
    return obs['goal_delta_angstroms'] * 0.1

  def t_base(gen, obs):
    del gen
    seen['torch'] = obs['goal_delta_angstroms'].numpy()
    return obs['goal_delta_angstroms'] * 0.1

  obs = {'image': maps[..., None], 'goal_delta_angstroms': goal,
         'fov_lower_left': ll, 'fov_upper_right': ur}
  pstate = dict(prev_map=prev_map, prev_ll=prev_ll, drift=drift)
  j_state, j_action = j_dc.DriftCorrectedPolicy(j_base).step(
      {k: jnp.asarray(v) for k, v in pstate.items()}, jax.random.PRNGKey(0),
      {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(first))
  t_policy = t_dc.DriftCorrectedPolicy(t_base)
  assert isinstance(t_policy, t_eval_lib.StatefulPolicy)
  t_state, t_action = t_policy.step(
      {k: _t(v) for k, v in pstate.items()}, None,
      {k: _t(v) for k, v in obs.items()}, _t(first))
  np.testing.assert_allclose(t_state['drift'].numpy(),
                             np.asarray(j_state['drift']), atol=5e-4)
  # The base policy saw the goal plus the new drift estimate.
  np.testing.assert_allclose(seen['torch'], goal + t_state['drift'].numpy(),
                             atol=1e-6)
  np.testing.assert_allclose(seen['torch'], seen['jax'], atol=5e-4)
  np.testing.assert_allclose(t_action.numpy(), np.asarray(j_action),
                             atol=5e-5)


# --- the two vision-planner policies on a drifting honeycomb -----------------

# A fixed 1x1 convolution as the detector: background at 0, carbon at 0.5,
# silicon at 1.0 (slopes and offsets of the three class logits).
W_1X1 = np.array([0.0, 8.0, 24.0], np.float32)
B_1X1 = np.array([0.0, -2.0, -16.0], np.float32)


def _j_detector(image):
  return image * jnp.asarray(W_1X1) + jnp.asarray(B_1X1)


def _t_detector(image):
  return image * _t(W_1X1) + _t(B_1X1)


def _scene(si_px_list, bond_px, theta0):
  """(S, S) frame: Gaussian atoms of a honeycomb, carbon at 0.5 and the
  listed silicon sites at 1.0. Pixel coordinates are the math frame of
  imaging/render.py: x = col, y = S-1 - row."""
  col, row = np.meshgrid(np.arange(S), np.arange(S))
  x, y = col.astype(np.float64), (S - 1 - row).astype(np.float64)
  c, s = np.cos(theta0), np.sin(theta0)
  rot = np.array([[c, -s], [s, c]])
  a1 = rot @ (bond_px * np.array([1.5, np.sqrt(3) / 2]))
  a2 = rot @ (bond_px * np.array([1.5, -np.sqrt(3) / 2]))
  d = rot @ (bond_px * np.array([1.0, 0.0]))
  origin = np.asarray(si_px_list[0])
  frame = np.zeros((S, S))
  n = int(S / bond_px) + 3
  sigma = 0.18 * bond_px
  for n1 in range(-n, n + 1):
    for n2 in range(-n, n + 1):
      base = origin + n1 * a1 + n2 * a2
      for site in (base, base + d):
        if not (-6 < site[0] < S + 6 and -6 < site[1] < S + 6):
          continue
        is_si = any(np.linalg.norm(site - np.asarray(p)) < 0.25
                    for p in si_px_list)
        blob = np.exp(-((x - site[0])**2 + (y - site[1])**2)
                      / (2 * sigma**2))
        frame = np.maximum(frame, (1.0 if is_si else 0.5) * blob)
  return frame


def _drifting_frames(num_dopants, steps=4, seed=5):
  """Frames of three scenes whose sample drifts by a known U(-0.5, 0.5) A
  per axis each step, under a believed FOV that stands still; the goal
  deltas (B, D*2) of the drift-free frame, one row latched when D = 2."""
  rng = np.random.default_rng(seed)
  scenes = [(0.15, 9.0), (-0.8, 9.0), (0.6, 11.0)]
  batch = len(scenes)
  ppa = np.array([bond_px / BOND for _, bond_px in scenes])  # px per A
  width = S / ppa
  ll = np.stack([np.full(2, -w / 2) for w in width]).astype(np.float32)
  ur = (ll + width[:, None]).astype(np.float32)
  drift = np.zeros((batch, 2))
  frames, drifts = [], []
  for _ in range(steps):
    frames_t = []
    for b, (theta0, bond_px) in enumerate(scenes):
      c, s = np.cos(theta0), np.sin(theta0)
      rot = np.array([[c, -s], [s, c]])
      si_a = np.array([30.0, 33.0]) + drift[b] * ppa[b]
      sites = [si_a]
      if num_dopants == 2:
        sites.append(si_a + rot @ (bond_px * np.array([3.0, np.sqrt(3)])))
      frames_t.append(_scene(sites, bond_px, theta0))
    frames.append(np.stack(frames_t)[..., None].astype(np.float32))
    drifts.append(drift.copy())
    drift = drift + rng.uniform(-0.5, 0.5, drift.shape)
  goal = rng.uniform(-4, 4, (batch, num_dopants, 2))
  if num_dopants == 2:
    goal[1, 0] = 0.0  # latched: the other dopant is the anchor
  return frames, drifts, goal.reshape(batch, -1).astype(np.float32), ll, ur


def _capture(monkeypatch, module, name, store):
  original = getattr(module, name)

  def wrapper(probs, deltas, **kwargs):
    store.append((np.asarray(deltas), kwargs.get('live')))
    return original(probs, deltas, **kwargs)

  monkeypatch.setattr(module, name, wrapper)


def _run_policies(j_policy, t_policy, frames, goal, ll, ur):
  """Both policies over the frames; FIRST at step 0 everywhere and at step
  2 for row 2 (an auto-reset row). Returns per step (j_state, t_state,
  j_action, t_action)."""
  out = []
  j_pstate = t_pstate = None
  for i, frame in enumerate(frames):
    obs = {'image': frame, 'goal_delta_angstroms': goal,
           'fov_lower_left': ll, 'fov_upper_right': ur}
    j_obs = {k: jnp.asarray(v) for k, v in obs.items()}
    t_obs = {k: _t(v) for k, v in obs.items()}
    if i == 0:
      j_pstate, t_pstate = j_policy.init(j_obs), t_policy.init(t_obs)
    first = np.array([i == 0, i == 0, i in (0, 2)])
    j_pstate, j_action = j_policy.step(j_pstate, jax.random.PRNGKey(i),
                                       j_obs, jnp.asarray(first))
    t_pstate, t_action = t_policy.step(t_pstate, None, t_obs, _t(first))
    out.append((j_pstate, t_pstate, np.asarray(j_action), t_action.numpy()))
  return out


def _same_candidate(got, want):
  # The actions are candidates of one grid: the same candidate (1e-4) or,
  # at a near tie of the two best scores, a neighbouring one.
  same = np.abs(got - want).max(-1) <= 1e-4
  assert same.sum() >= len(got) - 1, (got, want)
  assert np.abs(got - want).max() <= 0.12


def test_drift_corrected_vision_planner_policy_matches_jax(monkeypatch):
  frames, drifts, goal, ll, ur = _drifting_frames(1)
  kwargs = dict(dwell_seconds=5.0, max_distance_angstroms=2 * BOND)
  j_policy = j_dc.DriftCorrectedVisionPlannerPolicy(
      detector_fn=_j_detector, rate_fn=j_rates.simple_canonical_rates,
      candidates=j_planner.make_candidate_offsets(max_radius=2 * BOND),
      **kwargs)
  t_policy = t_dc.DriftCorrectedVisionPlannerPolicy(
      detector_fn=_t_detector, rate_fn=t_rates.simple_canonical_rates,
      candidates=t_planner.make_candidate_offsets(max_radius=2 * BOND),
      **kwargs)
  j_seen, t_seen = [], []
  _capture(monkeypatch, j_vp, 'vision_planner_policy_from_probs', j_seen)
  _capture(monkeypatch, t_vp, 'vision_planner_policy_from_probs', t_seen)
  steps = _run_policies(j_policy, t_policy, frames, goal, ll, ur)
  for i, (j_state, t_state, j_action, t_action) in enumerate(steps):
    est = t_state['drift'].numpy()
    # The carry: 5e-4 A (1e-3 px of shift at ~6-8 px per A).
    np.testing.assert_allclose(est, np.asarray(j_state['drift']), atol=5e-4)
    np.testing.assert_allclose(t_state['prev_ll'].numpy(), ll)
    assert torch.equal(t_state['prev_map'],
                       torch.softmax(_t_detector(_t(frames[i])), -1)[..., 1])
    # The corrected goal the planner saw: goal + estimate, as in JAX.
    np.testing.assert_allclose(t_seen[i][0], goal + est, atol=1e-6)
    np.testing.assert_allclose(t_seen[i][0], j_seen[i][0], atol=5e-4)
    _same_candidate(t_action, j_action)
    # The estimate follows the true drift since each row's last FIRST.
    start = [0, 0, 2 if i >= 2 else 0]
    true = drifts[i] - np.stack([drifts[k][b] for b, k in enumerate(start)])
    np.testing.assert_allclose(est, true, atol=0.3)
  assert np.all(steps[2][1]['drift'].numpy()[2] == 0.0)


def test_drift_corrected_multi_dopant_policy_matches_jax(monkeypatch):
  frames, drifts, goal, ll, ur = _drifting_frames(2)
  kwargs = dict(num_dopants=2, dwell_seconds=5.0,
                max_distance_angstroms=2 * BOND, min_separation_px=8.0)
  j_policy = j_dc.DriftCorrectedMultiDopantVisionPlannerPolicy(
      detector_fn=_j_detector, rate_fn=j_rates.simple_canonical_rates,
      candidates=j_planner.make_candidate_offsets(max_radius=2 * BOND),
      **kwargs)
  t_policy = t_dc.DriftCorrectedMultiDopantVisionPlannerPolicy(
      detector_fn=_t_detector, rate_fn=t_rates.simple_canonical_rates,
      candidates=t_planner.make_candidate_offsets(max_radius=2 * BOND),
      **kwargs)
  j_seen, t_seen = [], []
  name = 'multi_dopant_vision_planner_policy_from_probs'
  _capture(monkeypatch, j_vp, name, j_seen)
  _capture(monkeypatch, t_vp, name, t_seen)
  steps = _run_policies(j_policy, t_policy, frames, goal, ll, ur)
  deltas = goal.reshape(3, 2, 2)
  live = np.linalg.norm(deltas, axis=-1) > 1e-6
  assert not live[1, 0] and live.sum() == 5
  for i, (j_state, t_state, j_action, t_action) in enumerate(steps):
    est = t_state['drift'].numpy()
    assert est.shape == (3, 2)
    np.testing.assert_allclose(est, np.asarray(j_state['drift']), atol=5e-4)
    corrected, t_live = t_seen[i]
    j_corrected, j_live = j_seen[i]
    # `live` from the uncorrected deltas; the latched dopant stays exactly
    # zero and the live ones move by the estimate.
    np.testing.assert_array_equal(t_live.numpy(), live)
    np.testing.assert_array_equal(np.asarray(j_live), live)
    assert np.all(corrected[1, 0] == 0.0) and np.all(j_corrected[1, 0] == 0.0)
    np.testing.assert_allclose(
        corrected[live], (deltas + est[:, None, :])[live], atol=1e-6)
    np.testing.assert_allclose(corrected, j_corrected, atol=5e-4)
    _same_candidate(t_action, j_action)


def test_agents_wrap_the_policies_on_the_shipped_detector():
  agent = t_dc.DriftCorrectedVisionPlannerAgent(
      rate_fn=t_rates.simple_canonical_rates, device='cpu')
  assert agent.max_distance_angstroms == pytest.approx(2 * BOND)
  assert isinstance(agent.policy(), t_dc.DriftCorrectedVisionPlannerPolicy)
  md_agent = t_dc.DriftCorrectedMultiDopantVisionPlannerAgent(
      rate_fn=t_rates.simple_canonical_rates, num_dopants=2, device='cpu')
  policy = md_agent.policy()
  assert isinstance(policy, t_dc.DriftCorrectedMultiDopantVisionPlannerPolicy)
  frames, _, goal, ll, ur = _drifting_frames(2, steps=1)
  obs = {'image': _t(np.repeat(np.repeat(frames[0], 4, 1), 4, 2)),
         'goal_delta_angstroms': _t(goal), 'fov_lower_left': _t(ll),
         'fov_upper_right': _t(ur)}
  pstate = policy.init(obs)
  pstate, action = policy.step(pstate, None, obs, torch.ones(3, dtype=bool))
  assert action.shape == (3, 2) and bool(torch.isfinite(action).all())
  assert float(pstate['drift'].abs().max()) == 0.0
