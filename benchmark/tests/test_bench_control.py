"""The control of the correctness check, at a size a test run holds: the
reference one precision below the configuration's (float32 -> TF32 with
its inputs rounded to TF32's mantissa; TF32 -> bfloat16), put in the
program's place, fails the cell's limits, where the program passes."""

import json
import os

import pytest

from benchmark import calibrate
from benchmark.tests import bench_tiny


@pytest.mark.parametrize('workload', ['pixels-eval-b1024', 'vision-eval-b100'])
def test_control_fails_where_the_program_passes(tmp_path, workload):
  root = bench_tiny.make_root(str(tmp_path), max_steps=8)
  with open(os.path.join(root, 'benchmark', 'limits', workload + '.json')) as f:
    limits = json.load(f)
  lines = calibrate.main(['--workload', workload, '--seeds', '31,32',
                          '--seconds', '0.5'], root=root, device='cpu')
  for line in lines:
    assert line['recorded'] == 5  # the reset, three loop steps, the accounting
    assert all(v <= limits[k] for k, v in line['program'].items()), line
    assert any(v > limits[k] for k, v in line['control'].items()), line
