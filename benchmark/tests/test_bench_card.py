"""The benchmark's command on the card: one short run of each cell, its
last line in the contract's form. Skips without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.lib import cells


@pytest.mark.cuda
@pytest.mark.parametrize('workload,trace', [
    ('pixels-eval-b1024', 0), ('vision-eval-b100', 1)])
def test_run_on_the_card(workload, trace):
  import torch

  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  proc = subprocess.run(
      [sys.executable, 'benchmark/run.py', '--workload', workload, '--seed',
       str(2**33 + 1), '--seconds', '2', '--trace', str(trace)],
      cwd=cells.ROOT, capture_output=True, text=True, timeout=900,
      env=dict(os.environ))
  assert proc.returncode == 0, proc.stderr[-4000:]
  line = json.loads(proc.stdout.strip().splitlines()[-1])
  assert line['correct'], line['checks']
  assert line['device']['platform'] == 'gpu'
  assert list(line)[-1] == 'checks'
  if trace:
    assert 0 < line['device']['busy_s'] <= line['device']['window_s']
    assert line['breakdown']['device_ops']
