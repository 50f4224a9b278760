"""What the benchmark must not load, by whole top-level module name, and
the run's refusals: no result without a card, none after a forbidden
import, none outside a checkout of the program."""

import os
import shutil
import subprocess
import sys
import types

from benchmark.lib import cells
from benchmark.lib import guard
from benchmark.tests import bench_tiny


def test_whole_top_level_names():
  assert guard.forbidden_loaded(['putting_dune_torch',
                                 'putting_dune_torch.ops._build',
                                 'benchmark.lib', 'jaxtyping',
                                 'scriptsy', 'benchmarks']) == []
  assert guard.forbidden_loaded(['putting_dune_tpu.env', 'jax.numpy',
                                 'flax.linen', 'bench', 'chip_smoke',
                                 'scripts.kernel_ab', 'jaxlib']) == [
                                     'bench', 'chip_smoke', 'flax', 'jax',
                                     'jaxlib', 'putting_dune_tpu', 'scripts']


def test_reference_imports_nothing_of_the_program():
  code = ('import sys; sys.path.insert(0, %r); import benchmark.reference.'
          'render, benchmark.reference.networks, benchmark.reference.planner,'
          ' benchmark.reference.rates, benchmark.reference.flax_msgpack; '
          'print(sorted({m.split(".")[0] for m in sys.modules}))' % cells.ROOT)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, check=True).stdout
  assert 'putting_dune_torch' not in out and 'jax' not in out


def test_no_result_without_a_card(tmp_path):
  if __import__('torch').cuda.is_available():
    return  # the look for a card passes on a machine that has one
  from benchmark import run

  lines, log = [], []
  rc = run.run(['--workload', 'pixels-eval-b1024', '--seed', '1',
                '--seconds', '1'], out=types.SimpleNamespace(
                    write=lines.append, flush=lambda: None), log=log.append)
  assert rc != 0 and not lines and 'CUDA' in log[0]


def test_no_result_after_a_forbidden_import(tmp_path, monkeypatch):
  root = bench_tiny.make_root(str(tmp_path))
  monkeypatch.setitem(sys.modules, 'jax', types.ModuleType('jax'))
  rc, line, err = bench_tiny.run_json(root, 'pixels-eval-b1024')
  assert rc != 0 and line is None
  assert any('forbidden modules loaded: jax' in e for e in err)


def test_no_result_outside_a_checkout(tmp_path):
  shutil.copytree(os.path.join(cells.ROOT, 'benchmark'),
                  tmp_path / 'benchmark',
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(os.path.join(cells.ROOT, 'BENCHMARK.json'), tmp_path)
  env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
  proc = subprocess.run(
      [sys.executable, 'benchmark/run.py', '--workload', 'pixels-eval-b1024',
       '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
      env=env, capture_output=True, text=True)
  assert proc.returncode != 0 and proc.stdout == ''
