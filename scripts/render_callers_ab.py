"""Two callers of `render_stem_image` off the benchmark's cells, timed on two
checkouts in turns on one card.

  python3 scripts/render_callers_ab.py OTHER_ROOT

OTHER_ROOT is another checkout of the repo (for example the parent commit,
unpacked with `git archive`). As scripts/kernel_ab.py does, the script runs
its own `--measure ROOT` mode in a fresh process for OTHER_ROOT, this
checkout, this checkout and OTHER_ROOT (a b b a); each process imports
`putting_dune_torch` from its ROOT and reads:

  * the batch-1 host loop: `python -m putting_dune_torch.eval
    --experiment_name=ppo_simple_images_tf --no-batched` on tiny_eval at the
    512^2 render, once to warm up and once timed (env steps/s on the host's
    clock, the CLI's own `env_steps / wall_seconds`);
  * the pixel PPO rollout at the 128^2 render: `relative_simple_rates_from_
    images` at batch 256, rollout 16 (chip_smoke.py phase 18b), one rollout
    to warm up, then the median of 5 rollouts, in ms per rollout step
    (synchronized host clock).

Prints one JSON line per process, the card's name and power limit, and last
a JSON line with both sides' medians. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str) -> dict:
  sys.path.insert(0, root)
  import torch

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import ppo
  from putting_dune_torch.ops import _build

  dev = torch.device('cuda')
  _build.build_all()
  args = eval_cli.Args('ppo_simple_images_tf', batched=False, device='cuda')
  eval_cli.main(args)
  report = eval_cli.main(args)
  result = {'root': root,
            'loop_env_steps': report['env_steps'],
            'loop_env_steps_per_s': report['env_steps'] / report['wall_seconds']}

  exp = registry.create_train_experiment('relative_simple_rates_from_images')
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=256,
      image_size=128, device=dev)
  config = ppo.PPOConfig(rollout_length=16, reward_shaping_coef=0.05)
  trainer = ppo.PPOTrainer(env, config)
  carry = trainer.init_carry(0)
  trainer.rollout(carry)
  times = []
  for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.rollout(carry)
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0) / config.rollout_length)
  result['rollout_128_ms_per_step'] = statistics.median(times)
  result['splat_render_launches'] = _build.LAUNCHES['splat_render']
  return result


def main() -> None:
  if sys.argv[1:2] == ['--measure']:
    print(json.dumps(measure(sys.argv[2])), flush=True)
    return
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  print(smi, flush=True)
  other = os.path.abspath(sys.argv[1])
  runs = {other: [], ROOT: []}
  for root in (other, ROOT, ROOT, other):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--measure', root],
        capture_output=True, text=True, cwd=root, timeout=900)
    if out.returncode != 0:
      print(out.stdout[-3000:], out.stderr[-3000:], flush=True)
      sys.exit(1)
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    runs[root].append(json.loads(line))
  keys = ('loop_env_steps_per_s', 'rollout_128_ms_per_step')
  summary = {label: {k: statistics.median(r[k] for r in runs[root])
                     for k in keys}
             for label, root in (('other', other), ('this', ROOT))}
  print(json.dumps({'device': smi, 'other': other, 'summary': summary}),
        flush=True)


if __name__ == '__main__':
  main()
