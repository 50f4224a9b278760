"""The plain reference against the port at a small size on the CPU: each
stage alone, and the whole check of a run of each cell."""

import numpy as np
import pytest
import torch

from benchmark.lib import cells
from benchmark.reference import flax_msgpack
from benchmark.reference import networks
from benchmark.reference import planner
from benchmark.reference import rates as ref_rates
from benchmark.reference import render
from benchmark.reference import transition
from benchmark.tests import bench_tiny

WEIGHTS = 'putting_dune_tpu/experiments/model_weights'


def test_msgpack_reader_matches_the_ports():
  from putting_dune_torch.agents import eval_agent

  path = f'{cells.ROOT}/{WEIGHTS}/ppo_simple_images_tf/policy.ckpt'
  ours, theirs = flax_msgpack.load(path), eval_agent.read_flax_params(path)
  assert sorted(ours) == sorted(theirs)
  for name, leaf in theirs.items():
    if isinstance(leaf, dict):
      for k, v in leaf.items():
        np.testing.assert_array_equal(ours[name][k], v)


def test_lattice_matches_the_ports():
  from putting_dune_torch import lattice

  np.testing.assert_array_equal(
      render.graphene_positions(50),
      lattice.make_lattice(50).positions.numpy())


def test_philox_draws_match_the_ports_twin():
  from putting_dune_torch.ops import noise_fused

  seeds = torch.tensor([3, 2**40 + 7, 2**62 - 1], dtype=torch.int64)
  ours = render.draws_from_seeds(seeds, 8, 16, frame_offset=1, frames=2)
  theirs = noise_fused.draws_from_seeds(seeds, 3, 8, 16, 'cpu')
  for k, v in ours.items():
    torch.testing.assert_close(v, theirs[k][1:], rtol=0, atol=0)


def test_noise_chain_and_clahe_match_the_ports_twins():
  from putting_dune_torch.ops import clahe_fused
  from putting_dune_torch.ops import noise_fused

  gen = torch.Generator().manual_seed(0)
  image = torch.rand((2, 64, 64), generator=gen)
  params = {name: torch.rand((2,), generator=gen) * 0.2 + 0.5
            for name in render.NOISE_PARAMS}
  params['poisson_rate_multiplier'] = torch.tensor([3.0, 40.0])
  draws = noise_fused.sample_draws(gen, 2, 64, 64, 'cpu')
  packed = torch.stack([params[n] for n in render.NOISE_PARAMS]
                       + [torch.zeros(2)], 1)
  ours = render.noise_chain(image, params, draws)
  theirs = noise_fused.chain_from_uniforms(image, packed, draws)
  torch.testing.assert_close(ours, theirs, rtol=0, atol=0)
  torch.testing.assert_close(render.clahe(ours),
                             clahe_fused.clahe_reference(ours),
                             rtol=0, atol=1e-6)


def test_splat_matches_the_ports():
  from putting_dune_torch import lattice
  from putting_dune_torch import simulator
  from putting_dune_torch import structures
  from putting_dune_torch.imaging import render as port_render

  lat = lattice.make_lattice(20)
  gen = torch.Generator().manual_seed(3)
  offset = torch.rand((2, 2), generator=gen) - 0.5
  theta = torch.rand((2,), generator=gen) * 6
  si = lattice.initial_silicon_index(lat, offset)
  centre = lattice.site_position(lat, si, offset, theta)
  fov = structures.FieldOfView(centre - 9.0, centre + 11.0)
  material = structures.MaterialState(offset=offset, theta=theta,
                                      si_index=si)
  window = simulator.atom_window(lat, material, fov, 512)
  exponent, blur = torch.tensor([1.5, 1.9]), torch.tensor([0.3, 0.9])
  theirs = port_render.render_clean_image(window, fov, exponent,
                                          image_size=64, blur_amount=blur)
  micro, z = render.atoms_in_view(
      torch.from_numpy(render.graphene_positions(20)), offset, theta, si,
      fov.lower_left, fov.upper_right, 512)
  ours = render.splat(micro, z, fov.width, fov.height, exponent, blur, 64)
  torch.testing.assert_close(ours, theirs, rtol=0, atol=0)


def test_networks_match_the_ports():
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.atom_detection import model as det_model

  gen = torch.Generator().manual_seed(1)
  ac_dir = f'{cells.ROOT}/{WEIGHTS}/ppo_simple_images_tf'
  port_ac = eval_agent.load_policy(ac_dir, 'cpu')
  image = torch.rand((2, 128, 128, 1), generator=gen)
  goal = torch.randn((2, 2), generator=gen)
  params = networks.tensors(flax_msgpack.load(f'{ac_dir}/policy.ckpt'), 'cpu')
  with torch.no_grad():
    torch.testing.assert_close(
        networks.actor_critic_mean(params, image, goal),
        port_ac({'image': image, 'goal_delta_angstroms': goal})[0],
        rtol=0, atol=1e-5)
  det = flax_msgpack.load(f'{cells.ROOT}/{WEIGHTS}/atom_detector/'
                          'params.msgpack')
  unet = det_model.UNet()
  unet.load_state_dict(det_model.params_from_flax(det))
  frames = torch.rand((1, 32, 32, 1), generator=gen)
  with torch.no_grad():
    torch.testing.assert_close(
        networks.unet_logits(networks.tensors(det, 'cpu'), frames),
        unet(frames), rtol=0, atol=1e-3)


def test_planner_matches_the_ports():
  from putting_dune_torch import rates
  from putting_dune_torch.agents import planner as port_planner
  from putting_dune_torch.agents import vision_planner

  gen = torch.Generator().manual_seed(2)
  probs = torch.softmax(torch.randn((2, 64, 64, 3), generator=gen) * 3, -1)
  goal = torch.randn((2, 2), generator=gen) * 4
  cand = port_planner.make_candidate_offsets(max_radius=2.84)
  np.testing.assert_array_equal(planner.candidates(2.84), cand)
  theta0 = planner.bond_orientation(probs[..., 2], probs[..., 1])
  _, _, port_theta0 = vision_planner.estimate_lattice_frame(
      probs[..., 2], probs[..., 1])
  torch.testing.assert_close(theta0, port_theta0, rtol=0, atol=1e-5)
  grid = torch.as_tensor(cand)[None].expand(2, -1, -1)
  action = vision_planner.vision_planner_policy_from_probs(
      probs, goal, rate_fn=rates.simple_canonical_rates, dwell_seconds=5.0,
      max_distance_angstroms=2.84, candidates=cand)
  scores = planner.scores(theta0, goal, grid, 5.0)
  chosen = planner.scores(theta0, goal, (action * 2.84)[:, None], 5.0)
  torch.testing.assert_close(chosen[:, 0], scores.amax(-1), rtol=0,
                             atol=1e-6)


def test_neighbor_table_matches_the_ports():
  from putting_dune_torch import lattice

  np.testing.assert_array_equal(transition.neighbor_table(50),
                                lattice.make_lattice(50).neighbors.numpy())


def test_transition_replay_matches_the_ports_steps():
  from putting_dune_torch import rates as port_rates
  from putting_dune_torch import simulator
  from putting_dune_torch.env import action_adapters
  from putting_dune_torch.env import env as env_lib

  driver = cells.load_module('drivers', 'batched_eval')
  batch = 64
  env = env_lib.PuttingDuneEnv(
      rate_fn=port_rates.simple_canonical_rates,
      adapter=action_adapters.RelativeToSiliconActionAdapter(),
      # Narrow fields of view, so that the silicon leaves the safe area.
      config=env_lib.EnvConfig(
          sim=simulator.SimulatorConfig(fov_scale_min=4.0, fov_scale_max=6.0),
          step_limit=12),
      batch_size=batch,
      device='cpu')
  config = {'grid_columns': 50, 'dwell_seconds': 1.5, 'step_limit': 12,
            'max_distance_angstroms': 1.42, 'image_duration_seconds': 2.0}
  gen = env_lib.make_generator(2**33 + 3, 'cpu')
  actions = torch.Generator().manual_seed(4)
  state, _ = env.reset(gen)
  rate_fn, hops, recentered, ends = env.rate_fn, 0, 0, 0
  for _ in range(16):
    action = torch.rand((batch, 2), generator=actions) * 2.0 - 1.0
    before = driver._before(state)
    draws = driver._DrawRecorder()

    def recording(*args, draws=draws):
      draws.after_rates = True
      return rate_fn(*args)

    env.rate_fn = recording
    with draws:
      state, ts = env.step(state, action, gen)
    env.rate_fn = rate_fn
    ref = transition.step(before, action, draws.kmc,
                          law=ref_rates.simple_canonical, env=config)
    keep = ~before['needs_reset']
    assert not ref['rounds_off'].any()
    sim = state.sim
    torch.testing.assert_close(sim.material.si_index[keep],
                               ref['si_index'][keep], rtol=0, atol=0)
    for got, want in ((sim.fov.lower_left, 'lower_left'),
                      (sim.fov.upper_right, 'upper_right'),
                      (ts.elapsed_seconds, 'elapsed_seconds'),
                      (ts.reward, 'reward')):
      torch.testing.assert_close(got[keep], ref[want][keep], rtol=0, atol=0)
    torch.testing.assert_close(ts.step_type[keep].long(),
                               ref['step_type'][keep], rtol=0, atol=0)
    hops += int((ref['si_index'] != before['si_index'])[keep].sum())
    recentered += int((ref['lower_left'] != before['lower_left'])
                      .any(-1)[keep].sum())
    ends += int((ref['step_type'] == transition.LAST)[keep].sum())
  assert hops > 0 and recentered > 0 and ends > 0


def test_episode_accounting_by_hand():
  last, mid = transition.LAST, transition.MID
  # Three episodes over four steps of 10 s from 2 s: the first ends at its
  # goal on step 2, the second at its step limit on step 3 (discount > 0),
  # the third times out once 2 + 10 k + the wall passes 35 s.
  steps = [(torch.tensor(t), torch.tensor(d), torch.full((3,), 10.0))
           for t, d in (((mid, mid, mid), (1., 1., 1.)),
                        ((last, mid, mid), (0., 1., 1.)),
                        ((mid, last, mid), (1., .5, 1.)),
                        ((mid, mid, mid), (1., 1., 1.)))]
  count = lambda walls: transition.episode_actions(  # noqa: E731
      torch.full((3,), 2.0), steps, walls, chunk_steps=2, timeout_seconds=35.0)
  actions, reached = count([0.0, 0.0])
  assert actions.tolist() == [2, 3, 4] and reached.tolist() == [True, False,
                                                                 False]
  actions, _ = count([0.0, 4.0])  # 2 + 30 + 4 > 35 after step 3
  assert actions.tolist() == [2, 3, 3]


@pytest.mark.parametrize('workload', ['pixels-eval-b1024', 'vision-eval-b100'])
def test_whole_check_of_a_small_run(tmp_path, workload):
  root = bench_tiny.make_root(str(tmp_path))
  rc, line, err = bench_tiny.run_json(root, workload, seed=2**33 + 5)
  assert rc == 0, err
  assert line['correct'], line['checks']
  assert line['attempted'] > 0
  assert set(line['metrics']) == {'env_steps_per_s', 'setup_s'}
  assert list(line)[-1] == 'checks'
