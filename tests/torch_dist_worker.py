"""One rank of a two-rank torch.distributed (gloo, CPU) run, for
tests/test_torch_parallel.py. It imports nothing of JAX.

  python tests/torch_dist_worker.py SCENARIO RANK WORLD PORT OUTDIR

reads its inputs from OUTDIR (written by the test) and writes
OUTDIR/rank{RANK}.npz. Scenarios: 'ppo' (two data-parallel PPO updates on
the toy env with replayed draws), 'rate' (the rate learner's model axis),
'graph' (two graph-aligner steps on this rank's half of a fixed batch),
'cli' (the graph-aligner train CLI with the multi-process flags) and
'resume' (the graph-aligner trainer run three times, each rank in a
workdir of its own: a first epoch, a rerun to two epochs that every rank
resumes from rank 0's checkpoint, and a rerun that rank 1 alone asks to
stop).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_toy_env  # noqa: E402
from putting_dune_torch.parallel import mesh as mesh_lib  # noqa: E402

torch.set_num_threads(1)


def _flat(tree, prefix=''):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f'{prefix}{k}/'))
    else:
      out[f'{prefix}{k}'] = np.asarray(v)
  return out


def _unflat(arrays):
  tree = {}
  for key, value in arrays.items():
    node = tree
    *path, leaf = key.split('/')
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = np.asarray(value)
  return tree


def ppo(rank, world, outdir):
  from putting_dune_torch.agents import ppo as t_ppo

  inputs = np.load(os.path.join(outdir, 'inputs.npz'))
  table = inputs['table']
  block = table.shape[1] // world
  env = torch_toy_env.ToyEnv(table[:, rank * block:(rank + 1) * block])
  config = t_ppo.PPOConfig(hidden=(32, 32), rollout_length=8, num_epochs=2,
                           num_minibatches=2, reward_shaping_coef=0.05)
  mesh = mesh_lib.make_mesh(device='cpu')
  init_params = _unflat({k[len('init/'):]: v for k, v in inputs.items()
                         if k.startswith('init/')})
  init_carry, run_updates = t_ppo.make_train_fns(env, config, mesh)
  carry = init_carry(5, init_params)
  noise = torch.from_numpy(inputs['noise'][:, :, rank * block:
                                           (rank + 1) * block])
  carry, metrics = run_updates(carry, 2, noise=noise,
                               perms=torch.from_numpy(inputs['perms']))
  return {**_flat(t_ppo.actor_critic_to_flax(carry.model)),
          **{f'metric/{k}': v.numpy() for k, v in metrics.items()}}


def rate(rank, world, outdir):
  from putting_dune_torch.rate_learning import config as config_lib
  from putting_dune_torch.rate_learning import train as train_lib

  inputs = np.load(os.path.join(outdir, 'inputs.npz'))
  config = config_lib.RateLearningConfig(batch_size=8, epochs=3,
                                         num_models=4, hidden_dimensions=(16,))
  train = {k[len('train/'):]: v for k, v in inputs.items()
           if k.startswith('train/')}
  test = {k[len('test/'):]: v for k, v in inputs.items()
          if k.startswith('test/')}
  mesh = mesh_lib.make_mesh([world], ('model',), device='cpu')
  model, _, metrics = train_lib.train_multiple_models(
      train, test, torch.Generator().manual_seed(0), 4, config,
      device='cpu', mesh=mesh)
  return {**{f'param/{k}': v.numpy() for k, v in model.state_dict().items()},
          **{f'metric/{k}': v for k, v in metrics.items()}}


def graph(rank, world, outdir):
  from putting_dune_torch.graph_alignment import train as g_train

  inputs = np.load(os.path.join(outdir, 'inputs.npz'))
  config = g_train.Config(workdir=outdir, batch_size=4, capacity=64,
                          width=32, num_layers=2, k=4)
  mesh = mesh_lib.make_mesh(device='cpu')
  batch = mesh_lib.shard_batch(
      {k: torch.from_numpy(v) for k, v in inputs.items()}, mesh)
  state = g_train.create_state(config, 'cpu')
  for _ in range(2):
    g_train.train_step(state, batch, mesh=mesh)
  return {k: v.numpy() for k, v in state.model.state_dict().items()}


def cli(rank, world, port, outdir):
  from putting_dune_torch.graph_alignment import train as g_train
  from putting_dune_torch.utils import cli as cli_lib

  state = cli_lib.run_train_cli(g_train.Config, g_train.train, '', [
      f'--workdir={outdir}/run', '--epochs=1', '--steps_per_epoch=2',
      '--eval_steps=1', '--batch_size=4', '--capacity=64', '--width=32',
      '--num_layers=2', '--k=4', '--device=cpu',
      f'--coordinator_address=localhost:{port}', f'--num_processes={world}',
      f'--process_id={rank}'])
  return {'world': np.asarray(mesh_lib.world()[1]),
          **{k: v.numpy() for k, v in state.model.state_dict().items()}}


def resume(rank, world, outdir):
  from putting_dune_torch.graph_alignment import train as g_train

  mesh = mesh_lib.make_mesh(device='cpu')
  starts, counts = [], []
  for epochs, stop in ((1, False), (2, False), (4, rank == 1)):
    config = g_train.Config(workdir=f'{outdir}/run{rank}', epochs=epochs,
                            steps_per_epoch=2, eval_steps=1, batch_size=4,
                            capacity=64, width=32, num_layers=2, k=4)
    ran = []
    state = g_train.train(config, device='cpu', mesh=mesh,
                          progress=lambda e, _: ran.append(e),
                          stop_fn=lambda: stop)
    starts.append(ran[0] if ran else -1)
    counts.append(len(ran))
  return {'starts': np.asarray(starts), 'counts': np.asarray(counts),
          **{f'param/{k}': v.numpy()
             for k, v in state.model.state_dict().items()}}


def main():
  scenario, rank, world, port, outdir = sys.argv[1:6]
  rank, world = int(rank), int(world)
  if scenario == 'cli':
    out = cli(rank, world, port, outdir)
  else:
    mesh_lib.initialize_distributed(f'localhost:{port}', world, rank,
                                    device='cpu')
    out = {'ppo': ppo, 'rate': rate, 'graph': graph, 'resume': resume}[
        scenario](
        rank, world, outdir)
  np.savez(os.path.join(outdir, f'rank{rank}.npz'), **out)
  mesh_lib.shutdown()


if __name__ == '__main__':
  main()
