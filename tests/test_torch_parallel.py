"""The port's data-parallel meshes (parallel/mesh.py) and the trainers and
the evaluator over them, on the CPU.

Mirrors the JAX package's tests/test_parallel.py (mesh specs, the local
batch size, the seed identity, shard_batch / global_batch), then runs
two-rank `gloo` worlds in subprocesses (tests/torch_dist_worker.py), never
in the pytest worker, each under its own time limit:

  * PPO: two updates on the toy env with the JAX key chain replayed, each
    rank holding half the envs, within 1e-6 of the port's one-rank update
    and within 1e-5 of the JAX package's mesh update on 2 host devices;
  * the rate learner's model axis: within 1e-6 of the one-rank ensemble;
  * the graph aligner: two steps on halves of a fixed global batch within
    1e-6 of the one-rank steps;
  * the train CLI's multi-process flags: both processes end with equal
    parameters;
  * the perception loop's resume and stop: ranks in workdirs of their own
    resume from rank 0's checkpoint, and stop together when one asks;
  * the eval CLI's --mesh=data:2: every seed once, in order, with a
    success rate in law with the unsharded run.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_toy_env
import torch_toy_env
from test_torch_ppo import _replay_ppo_draws
from putting_dune_torch.agents import ppo as t_ppo
from putting_dune_torch.parallel import mesh as t_mesh
from putting_dune_torch.rate_learning import config as t_rate_config
from putting_dune_torch.rate_learning import data_utils as t_data_utils
from putting_dune_torch.rate_learning import train as t_rate_train
from putting_dune_tpu.agents import ppo as j_ppo
from putting_dune_tpu.parallel import mesh as j_mesh

WORKER = pathlib.Path(__file__).resolve().parent / 'torch_dist_worker.py'
REPO = WORKER.parent.parent
TIMEOUT = 60


# --- one process: the JAX package's tests/test_parallel.py ------------------


def test_initialize_distributed_is_noop_single_process():
  t_mesh.initialize_distributed()
  assert not torch.distributed.is_initialized()
  assert t_mesh.world() == (0, 1)


def test_process_local_batch_size_single_process():
  assert t_mesh.process_local_batch_size(32) == 32


def test_process_data_seed_identity_single_process():
  assert t_mesh.process_data_seed(7) == 7
  assert t_mesh.process_data_seed(0) == 0


def test_parse_mesh_spec():
  assert t_mesh.parse_mesh_spec('') is None
  assert t_mesh.parse_mesh_spec(None) is None
  one = t_mesh.parse_mesh_spec('data:1', 'cpu')
  assert one.shape == {'data': 1} and one.rank == 0 and not one.distributed
  with pytest.raises(ValueError, match='data'):
    t_mesh.parse_mesh_spec('model:2', 'cpu')
  with pytest.raises(ValueError, match='devices'):
    t_mesh.parse_mesh_spec('data:4096', 'cpu')
  # JAX's messages: the same words for the same mistakes.
  for spec in ('model:2', 'data:4096'):
    with pytest.raises(ValueError) as want:
      j_mesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
      t_mesh.parse_mesh_spec(spec, 'cpu')
    assert str(got.value).split(';')[0].split(' wants')[0] == str(
        want.value).split(';')[0].split(' wants')[0]


def test_global_batch_matches_shard_batch():
  mesh = t_mesh.make_mesh(device='cpu')
  batch = {
      'image': torch.arange(16 * 4 * 4, dtype=torch.float32).reshape(16, 4, 4),
      'label': torch.arange(16),
      'scalar': torch.tensor(3.0),
  }
  a = t_mesh.shard_batch(batch, mesh)
  b = t_mesh.global_batch(batch, mesh)
  for k in batch:
    assert torch.equal(a[k], batch[k]) and torch.equal(b[k], batch[k])
  assert t_mesh.batch_sharding(mesh).axis == 'data'
  assert t_mesh.replicated_sharding(mesh).axis is None


def test_shard_batch_takes_this_ranks_rows():
  mesh = t_mesh.Mesh(('data',), (4,), torch.device('cpu'))
  rows = np.arange(8)
  out = t_mesh.shard_batch({'x': rows, 'odd': np.arange(5)}, mesh)
  np.testing.assert_array_equal(out['x'], rows[:2])
  np.testing.assert_array_equal(out['odd'], np.arange(5))
  assert t_mesh.local_block(list(range(8)), mesh) == [0, 1]
  with pytest.raises(ValueError, match='split'):
    t_mesh.local_block(list(range(6)), mesh)


def test_ppo_dryrun_mesh_training_step():
  out = t_ppo.dryrun_mesh_training_step(t_mesh.make_mesh(device='cpu'))
  assert np.isfinite(out['loss']) and out['spread'] == 0.0


def test_ensemble_dryrun_training_step():
  mesh = t_mesh.make_mesh([1], ('model',), device='cpu')
  metrics = t_rate_train.dryrun_ensemble_training_step(mesh)
  assert metrics['train_loss'].shape == (2, 2)


def test_ppo_mesh_at_one_rank_is_the_unsharded_update():
  table = torch_toy_env.starts(16)
  config = t_ppo.PPOConfig(hidden=(16,), rollout_length=4, num_epochs=2,
                           num_minibatches=2, reward_shaping_coef=0.05)
  runs = []
  for mesh in (None, t_mesh.make_mesh(device='cpu')):
    init_carry, run_updates = t_ppo.make_train_fns(
        torch_toy_env.ToyEnv(table), config, mesh)
    carry, metrics = run_updates(init_carry(3), 2)
    runs.append((t_ppo.actor_critic_to_flax(carry.model), metrics))
  assert torch_toy_env.max_tree_diff(runs[0][0], runs[1][0]) == 0.0


# --- two ranks, in subprocesses ------------------------------------------------


def _run_ranks(scenario, outdir, world=2):
  port = t_mesh.free_port()
  env = dict(os.environ, PYTHONPATH=str(REPO))
  procs = [subprocess.Popen(
      [sys.executable, str(WORKER), scenario, str(rank), str(world),
       str(port), str(outdir)], stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True, env=env) for rank in range(world)]
  outputs = []
  try:
    for p in procs:
      out, _ = p.communicate(timeout=TIMEOUT)
      outputs.append(out)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, out in zip(procs, outputs):
    assert p.returncode == 0, out[-3000:]
  return [dict(np.load(os.path.join(outdir, f'rank{r}.npz')))
          for r in range(world)]


def _flat(tree, prefix=''):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f'{prefix}{k}/'))
    else:
      out[f'{prefix}{k}'] = np.asarray(v)
  return out


def test_two_rank_ppo_update_matches_one_rank_and_jax_mesh(tmp_path):
  table = torch_toy_env.starts(16)
  config = j_ppo.PPOConfig(hidden=(32, 32), rollout_length=8, num_epochs=2,
                           num_minibatches=2, reward_shaping_coef=0.05)
  init_params = j_ppo.ActorCritic(hidden=config.hidden).init(
      jax.random.PRNGKey(7), jnp.zeros((1, 6)))['params']
  init_np = jax.tree_util.tree_map(np.asarray, init_params)
  noise, perms = (x.numpy() for x in _replay_ppo_draws(0, config, 2, 16, 2))
  np.savez(tmp_path / 'inputs.npz', table=table, noise=noise, perms=perms,
           **{f'init/{k}': v for k, v in _flat(init_np).items()})
  ranks = _run_ranks('ppo', tmp_path)

  t_config = t_ppo.PPOConfig(**{
      f: getattr(config, f) for f in config.__dataclass_fields__})
  init_carry, run_updates = t_ppo.make_train_fns(
      torch_toy_env.ToyEnv(table), t_config)
  carry, one_metrics = run_updates(
      init_carry(5, init_np), 2, noise=torch.from_numpy(noise),
      perms=torch.from_numpy(perms))
  one = _flat(t_ppo.actor_critic_to_flax(carry.model))

  mesh = j_mesh.make_mesh([2], ('data',), devices=jax.devices()[:2])
  j_init, j_run, _ = j_ppo.make_train_fns(jax_toy_env.JaxToyEnv(table),
                                          config, mesh=mesh)
  j_carry, _ = j_run(j_init(jax.random.PRNGKey(0), init_params), 2)
  jax_params = _flat(jax.tree_util.tree_map(np.asarray, j_carry[0]))

  for name, value in one.items():
    assert np.array_equal(ranks[0][name], ranks[1][name]), name
    assert np.abs(ranks[0][name] - value).max() <= 1e-6, name
    assert np.abs(ranks[0][name] - jax_params[name]).max() <= 1e-5, name
  for name in t_ppo.METRIC_NAMES:
    np.testing.assert_allclose(ranks[0][f'metric/{name}'],
                               one_metrics[name].numpy(), atol=1e-6, rtol=0)
  # The update moved the parameters by more than the tolerance.
  assert max(np.abs(one[k] - v).max() for k, v in _flat(init_np).items()
             ) > 1e-4


def test_two_rank_ensemble_matches_one_rank(tmp_path):
  data, _ = t_data_utils.generate_synthetic_data(num_data=64, device='cpu')
  data = {k: v.numpy() for k, v in data.items()}
  train, test = t_rate_train.create_dataset_splits(data, 4, seed=0)
  np.savez(tmp_path / 'inputs.npz',
           **{f'train/{k}': v for k, v in train.items()},
           **{f'test/{k}': v for k, v in test.items()})
  ranks = _run_ranks('rate', tmp_path)
  config = t_rate_config.RateLearningConfig(
      batch_size=8, epochs=3, num_models=4, hidden_dimensions=(16,))
  model, _, metrics = t_rate_train.train_multiple_models(
      train, test, torch.Generator().manual_seed(0), 4, config, device='cpu')
  for name, value in model.state_dict().items():
    for r in ranks:
      assert np.abs(r[f'param/{name}'] - value.numpy()).max() <= 1e-6, name
  for name, value in metrics.items():
    for r in ranks:
      assert np.abs(r[f'metric/{name}'] - value).max() <= 1e-6, name


def test_two_rank_graph_aligner_steps_match_one_rank(tmp_path):
  from putting_dune_torch.graph_alignment import data as g_data
  from putting_dune_torch.graph_alignment import train as g_train

  config = g_train.Config(workdir=str(tmp_path), batch_size=4, capacity=64,
                          width=32, num_layers=2, k=4)
  batch = next(g_data.dataset_iterator(0, batch_size=4, capacity=64,
                                       grid_columns=20, device='cpu'))
  np.savez(tmp_path / 'inputs.npz', **{k: v.numpy() for k, v in
                                       batch.items()})
  ranks = _run_ranks('graph', tmp_path)
  state = g_train.create_state(config, 'cpu')
  for _ in range(2):
    g_train.train_step(state, batch)
  for name, value in state.model.state_dict().items():
    for r in ranks:
      assert np.abs(r[name] - value.numpy()).max() <= 1e-6, name


def test_multi_process_flags_train_to_equal_params(tmp_path):
  ranks = _run_ranks('cli', tmp_path)
  assert int(ranks[0]['world']) == int(ranks[1]['world']) == 2
  for name in ranks[0]:
    np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
  # Rank 0 alone wrote the checkpoint.
  assert os.listdir(tmp_path / 'run' / 'checkpoints')


def test_two_rank_trainer_resumes_and_stops_together(tmp_path):
  ranks = _run_ranks('resume', tmp_path)
  for r in ranks:
    # A first epoch; the rerun to two epochs resumes at epoch 1 on every
    # rank; the third run stops before its first epoch on rank 1's vote.
    np.testing.assert_array_equal(r['starts'], [0, 1, -1])
    np.testing.assert_array_equal(r['counts'], [1, 1, 0])
  for name in ranks[0]:
    np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
  # Rank 0 alone wrote checkpoints.
  assert os.listdir(tmp_path / 'run0' / 'checkpoints')
  assert not (tmp_path / 'run1' / 'checkpoints').exists() or not os.listdir(
      tmp_path / 'run1' / 'checkpoints')


@pytest.mark.parametrize('args', [
    dict(experiment_name='greedy_simple_rates'),
    dict(experiment_name='relative_random_simple', eval_suite='small_eval',
         step_limit=60, image_size=128, device='cpu', batched=False,
         video_save_dir='videos', seed=3, output_json='out/report.json',
         mesh='data:2'),
])
def test_eval_rank_argv_parses_back_to_args(args):
  from putting_dune_torch import eval as t_eval

  want = t_eval.Args(**args)
  assert t_eval._parse_args(t_eval.rank_argv(want)) == want


def test_eval_main_mesh_launches_ranks_with_its_args(tmp_path, monkeypatch):
  from putting_dune_torch import eval as t_eval

  # The ranks must run `args`, not this process's own command line.
  monkeypatch.setattr(sys, 'argv', ['pytest', '--not-an-eval-flag'])
  monkeypatch.chdir(REPO)
  monkeypatch.setenv('PYTHONPATH', str(REPO))
  out = tmp_path / 'sharded.json'
  report = t_eval.main(t_eval.Args(
      experiment_name='greedy_simple_rates', step_limit=60, device='cpu',
      mesh='data:2', output_json=str(out)))
  assert report is None  # the launching process; rank 0 wrote the file
  with open(out) as f:
    written = json.load(f)
  assert written['experiment'] == 'greedy_simple_rates'
  assert [r['seed'] for r in written['results']] == list(range(10))


def test_eval_cli_mesh_returns_every_seed_in_law(tmp_path):
  from putting_dune_torch import eval as t_eval

  argv = ['--experiment_name=relative_random_simple', '--eval_suite=tiny_eval',
          '--step_limit=60', '--device=cpu']
  out = tmp_path / 'sharded.json'
  run = subprocess.run(
      [sys.executable, '-m', 'putting_dune_torch.eval', *argv,
       '--mesh=data:2', f'--output_json={out}'], cwd=REPO, timeout=TIMEOUT,
      env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
      text=True)
  assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
  with open(out) as f:
    sharded = json.load(f)['results']
  assert [r['seed'] for r in sharded] == list(range(10))
  plain = t_eval.main(t_eval._parse_args(argv))['results']
  n = len(plain)
  p1 = np.mean([r['reached_goal'] for r in sharded])
  p2 = np.mean([r.reached_goal for r in plain])
  pooled = (p1 + p2) / 2
  if 0 < pooled < 1:
    assert abs(p1 - p2) / np.sqrt(pooled * (1 - pooled) * 2 / n) < 3
