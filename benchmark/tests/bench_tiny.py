"""A copy of the benchmark at CPU size for its tests: the cells as
BENCHMARK.json has them, on traffic mixes cut to a few envs, a 256^2
render and a step cap (the CPU cannot hold the timed sizes)."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.lib import cells

TINY = {'batch': 3, 'render_size': 256, 'max_steps': 16, 'warm_up_steps': 2,
        'traced_steps': 4, 'record_within': 4}


def make_root(path: str, **overrides) -> str:
  """A checkout-like root under `path`: BENCHMARK.json and benchmark/,
  each workload on a `<traffic>_tiny` mix."""
  shutil.copytree(os.path.join(cells.ROOT, 'benchmark'),
                  os.path.join(path, 'benchmark'),
                  ignore=shutil.ignore_patterns('__pycache__', 'tests'))
  with open(os.path.join(cells.ROOT, 'BENCHMARK.json')) as f:
    spec = json.load(f)
  traffic_dir = os.path.join(path, 'benchmark', 'traffic')
  for workload in spec['workloads']:
    with open(os.path.join(traffic_dir, workload['traffic'] + '.json')) as f:
      traffic = json.load(f)
    traffic.update(TINY, **overrides)
    workload['traffic'] += '_tiny'
    with open(os.path.join(traffic_dir, workload['traffic'] + '.json'),
              'w') as f:
      json.dump(traffic, f)
  with open(os.path.join(path, 'BENCHMARK.json'), 'w') as f:
    json.dump(spec, f)
  return path


def run_json(root: str, workload: str, seed: int = 5, trace: int = 0):
  """(exit code, the last line as JSON or None, standard error lines)."""
  import io

  from benchmark import run

  out, err = io.StringIO(), []
  rc = run.run(['--workload', workload, '--seed', str(seed), '--seconds',
                '0.5', '--trace', str(trace)], root=root, device='cpu',
               out=out, log=err.append)
  text = out.getvalue().strip()
  return rc, (json.loads(text.splitlines()[-1]) if text else None), err
