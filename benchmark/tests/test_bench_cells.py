"""A configuration, a traffic mix and a per-layer metric are added by new
files and entries alone: no file of the benchmark is edited."""

import json
import os

from benchmark.lib import cells
from benchmark.tests import bench_tiny


def test_new_cell_from_files_and_entries(tmp_path):
  root = bench_tiny.make_root(str(tmp_path))
  bench = os.path.join(root, 'benchmark')
  before = {p: open(os.path.join(dp, p), 'rb').read()
            for dp, _, files in os.walk(bench) for p in files
            if not p.endswith('.pyc')}
  with open(os.path.join(bench, 'configs', 'pixel_actor_critic.json')) as f:
    config = json.load(f)
  config['name'] = 'dummy_config'
  with open(os.path.join(bench, 'configs', 'dummy_config.json'), 'w') as f:
    json.dump(config, f)
  with open(os.path.join(bench, 'traffic', 'batched_eval_b1024_tiny.json')
            ) as f:
    traffic = json.load(f)
  traffic['batch'] = 2
  with open(os.path.join(bench, 'traffic', 'dummy_mix.json'), 'w') as f:
    json.dump(traffic, f)
  with open(os.path.join(bench, 'metrics', 'dummy.loop_steps.py'), 'w') as f:
    f.write('def read(ctx):\n  return float(ctx["counters"]["policy_calls"])\n')
  with open(os.path.join(bench, 'limits', 'pixels-eval-b1024.json')) as f:
    limits = json.load(f)
  with open(os.path.join(bench, 'limits', 'dummy-cell.json'), 'w') as f:
    json.dump(limits, f)
  spec_path = os.path.join(root, 'BENCHMARK.json')
  with open(spec_path) as f:
    spec = json.load(f)
  spec['configs'].append({'name': 'dummy_config', 'source': 'x',
                          'file': 'benchmark/configs/dummy_config.json',
                          'reduced': [], 'why': 'test'})
  spec['workloads'].append({'name': 'dummy-cell', 'config': 'dummy_config',
                            'traffic': 'dummy_mix', 'chips': 1, 'why': 't'})
  spec['per_layer'].append({'name': 'dummy.loop_steps', 'unit': 'steps',
                            'better': 'lower', 'source': 'program_counter',
                            'layer': 'eval loop', 'moves': 'env_steps_per_s',
                            'workloads': ['dummy-cell']})
  with open(spec_path, 'w') as f:
    json.dump(spec, f)

  cell = cells.load_cell('dummy-cell', root)
  assert cell.traffic['batch'] == 2 and cell.config['name'] == 'dummy_config'
  assert [m['name'] for m in cell.per_layer] == ['dummy.loop_steps']
  rc, line, _ = bench_tiny.run_json(root, 'dummy-cell', trace=1)
  assert rc == 0 and line['correct']
  assert line['metrics']['dummy.loop_steps']['value'] > 0
  after = {p: open(os.path.join(dp, p), 'rb').read()
           for dp, _, files in os.walk(bench) for p in files
           if p in before}
  assert after == before


DUMMY_DRIVER = '''
"""A traffic kind of the test: a few matmuls a step on the CPU."""
import time

import torch


class Session:
  def __init__(self, cell, seed, device):
    self.size = int(cell.traffic['size'])
    gen = torch.Generator().manual_seed(seed)
    self.x = torch.rand((self.size, self.size), generator=gen)
    self.steps = 0
    self.out = None

  def run_window(self, seconds, profiler=None):
    if profiler is not None:
      profiler.start()
      span = torch.profiler.record_function('bench.window')
      span.__enter__()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
      self.out = self.x @ self.x
      self.steps += 1
    elapsed = time.perf_counter() - start
    if profiler is not None:
      span.__exit__(None, None, None)
      profiler.stop()
    return {'seconds': elapsed, 'attempted': self.steps, 'failed': 0,
            'end_to_end': {'dummy_matmuls_per_s': self.steps / elapsed},
            'summary': f'{self.steps} matmuls'}

  def samples(self):
    return [{'x': self.x, 'out': self.out}]

  def expected_samples(self):
    return 1

  def release(self):
    pass

  def trace_context(self, samples):
    return {'steps': self.steps}


def setup(cell, seed, device):
  return Session(cell, seed, device)
'''

DUMMY_CHECK = '''
"""The product against NumPy's."""
import numpy as np


def compare(samples, config, traffic, control):
  x = samples[0]['x'].numpy().astype(np.float64)
  return {'matmul_gap': float(np.abs(samples[0]['out'].numpy() - x @ x).max())}
'''


def test_new_traffic_kind_brings_its_own_end_to_end_metric(tmp_path):
  """A driver, check, configuration, traffic mix and metrics of a kind
  the benchmark does not have, added by new files and entries alone."""
  root = bench_tiny.make_root(str(tmp_path))
  bench = os.path.join(root, 'benchmark')
  before = {os.path.join(dp, p): open(os.path.join(dp, p), 'rb').read()
            for dp, _, files in os.walk(bench) for p in files
            if not p.endswith('.pyc')}
  spec_before = open(os.path.join(root, 'BENCHMARK.json')).read()
  files = {
      'drivers/dummy_kind.py': DUMMY_DRIVER,
      'checks/dummy_matmul.py': DUMMY_CHECK,
      'metrics/dummy.steps.py': 'def read(ctx):\n  return float(ctx["steps"])\n',
      'configs/dummy_matmul.json': json.dumps(
          {'name': 'dummy_matmul', 'checks': ['dummy_matmul']}),
      'traffic/dummy_square.json': json.dumps(
          {'driver': 'dummy_kind', 'size': 64}),
      'limits/dummy-matmul.json': json.dumps({'matmul_gap': 1e-3}),
  }
  for name, text in files.items():
    with open(os.path.join(bench, name), 'w') as f:
      f.write(text)
  spec_path = os.path.join(root, 'BENCHMARK.json')
  with open(spec_path) as f:
    spec = json.load(f)
  spec['configs'].append({'name': 'dummy_matmul', 'source': 'x',
                          'file': 'benchmark/configs/dummy_matmul.json',
                          'reduced': [], 'why': 'test'})
  spec['workloads'].append({'name': 'dummy-matmul', 'config': 'dummy_matmul',
                            'traffic': 'dummy_square', 'chips': 1,
                            'why': 't'})
  spec['end_to_end'].append({'name': 'dummy_matmuls_per_s', 'unit': '1/s',
                             'better': 'higher', 'bound': 0.05,
                             'source': 'host_clock',
                             'workloads': ['dummy-matmul']})
  spec['per_layer'].append({'name': 'dummy.steps', 'unit': 'steps',
                            'better': 'higher', 'source': 'program_counter',
                            'layer': 'dummy', 'moves': 'dummy_matmuls_per_s',
                            'workloads': ['dummy-matmul']})
  with open(spec_path, 'w') as f:
    json.dump(spec, f)

  rc, line, err = bench_tiny.run_json(root, 'dummy-matmul', seed=2**33 + 9)
  assert rc == 0, err
  assert line['correct'], line['checks']
  assert set(line['metrics']) == {'dummy_matmuls_per_s', 'setup_s'}
  assert line['metrics']['dummy_matmuls_per_s']['value'] > 0
  rc, line, err = bench_tiny.run_json(root, 'dummy-matmul', seed=3, trace=1)
  assert rc == 0, err
  assert line['metrics']['dummy.steps']['value'] > 0
  after = {p: open(p, 'rb').read() for p in before}
  assert after == before
  assert json.loads(spec_before)['end_to_end'] == [
      m for m in spec['end_to_end'] if m['name'] != 'dummy_matmuls_per_s']
