"""Run-to-run spread of the pixel PPO trainer on the card, by determinism
mode, what each mode costs, and the world-1 mesh run against the
unsharded one.

  python scripts/ppo_determinism.py

Trains `relative_simple_rates_from_images` (batch 256, 128^2 render,
rollout 16, shaping 0.05) for 2 updates through the train CLI, twice in
each of three modes, and prints the largest parameter difference of each
pair:

  * default: cuDNN's default algorithms;
  * cudnn: `torch.backends.cudnn.deterministic = True` alone (every other
    op as in the default mode);
  * all: `torch.use_deterministic_algorithms(True)` (warn_only False, so an
    op with no deterministic variant raises), where a third run takes
    --mesh=data:1 (nccl over a localhost TCP store).

Then it times one more update of the same configuration in each mode, in
the order default, cudnn, all, default (ms a rollout step and a gradient
step, the median of 3). The script sets CUBLAS_WORKSPACE_CONFIG=:4096:8
before CUDA starts, which the `all` mode needs for cuBLAS; it holds in
every mode.
"""

import os
import sys
import tempfile

os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from putting_dune_torch import registry  # noqa: E402
from putting_dune_torch import run_helpers  # noqa: E402
from putting_dune_torch.agents import eval_agent  # noqa: E402
from putting_dune_torch.agents import ppo  # noqa: E402
from putting_dune_torch.agents import train_ppo  # noqa: E402

EXPERIMENT = 'relative_simple_rates_from_images'
ARGV = [f'--train_experiment={EXPERIMENT}', '--batch_size=256',
        '--num_updates=2', '--rollout_length=16', '--reward_shaping=0.05',
        '--render_size=128', '--eval_suite=']
REPEATS = 3


def set_mode(mode):
  torch.backends.cudnn.deterministic = mode == 'cudnn'
  torch.use_deterministic_algorithms(mode == 'all')


def run(workdir, extra=()):
  train_ppo.main(ARGV + [f'--workdir={workdir}', *extra])
  return chip_smoke._leaves(eval_agent.read_flax_params(
      os.path.join(workdir, 'policy', 'policy.ckpt')))


def diff(a, b):
  return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
             for x, y in zip(a, b))


def main():
  with tempfile.TemporaryDirectory() as tmp:
    for mode in ('default', 'cudnn', 'all'):
      set_mode(mode)
      a, b = run(f'{tmp}/{mode}a'), run(f'{tmp}/{mode}b')
      line = f'{mode}: plain vs plain {diff(a, b)}'
      if mode == 'all':
        line += f', mesh vs plain {diff(a, run(f"{tmp}/mesh", ["--mesh=data:1"]))}'
      print(line, flush=True)
  exp = registry.create_train_experiment(EXPERIMENT)
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=256,
      image_size=128, device='cuda')
  trainer = ppo.PPOTrainer(env, ppo.PPOConfig(num_updates=1,
                                              rollout_length=16,
                                              reward_shaping_coef=0.05))
  carry = trainer.init_carry(0)
  for mode in ('default', 'cudnn', 'all', 'default'):
    set_mode(mode)
    chip_smoke.time_update(trainer, carry)
    times = np.median([chip_smoke.time_update(trainer, carry)
                       for _ in range(REPEATS)], axis=0)
    print(f'{mode}: one update {times[0]:.4f} ms a rollout step, '
          f'{times[1]:.4f} ms a gradient step', flush=True)
  set_mode('default')
  print(chip_smoke.nvidia_smi_line(), flush=True)


if __name__ == '__main__':
  main()
