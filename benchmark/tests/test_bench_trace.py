"""Reading a trace: the union of overlapping device intervals, spans,
kernels by name, the breakdown, on a synthetic chrome trace."""

import json

import pytest

from benchmark.lib import trace as trace_lib


def _write(tmp_path, events):
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': [
      dict(ph='X', **e) for e in events]}))
  return trace_lib.load(str(path))


@pytest.fixture
def trace(tmp_path):
  return _write(tmp_path, [
      {'cat': 'user_annotation', 'name': 'bench.window', 'ts': 0, 'dur': 100},
      {'cat': 'user_annotation', 'name': 'bench.policy', 'ts': 0, 'dur': 10},
      {'cat': 'user_annotation', 'name': 'bench.env_step', 'ts': 10,
       'dur': 30},
      {'cat': 'cpu_op', 'name': 'aten::item', 'ts': 40, 'dur': 50},
      {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 2, 'dur': 1,
       'args': {'correlation': 1}},
      {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 12,
       'dur': 1, 'args': {'correlation': 2}},
      {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 14,
       'dur': 1, 'args': {'correlation': 3}},
      # Two streams overlap from 20 to 30: busy 10..40, not 50 us.
      {'cat': 'kernel', 'name': 'sgemm', 'ts': 10, 'dur': 20,
       'args': {'correlation': 1}},
      {'cat': 'kernel', 'name': 'noise_chain_kernel<1>', 'ts': 20, 'dur': 20,
       'args': {'correlation': 2}},
      {'cat': 'gpu_memcpy', 'name': 'Memcpy DtoH', 'ts': 60, 'dur': 10,
       'args': {'correlation': 3}},
      # Outside the window: ignored.
      {'cat': 'kernel', 'name': 'late', 'ts': 150, 'dur': 5,
       'args': {'correlation': 9}},
  ])


def test_union_merges_overlaps():
  assert trace_lib.union([(0, 5), (3, 8), (10, 12), (12, 13)]) == [
      (0, 8), (10, 13)]


def test_busy_and_window(trace):
  assert trace_lib.window_seconds(trace) == pytest.approx(100e-6)
  assert trace_lib.busy_seconds(trace) == pytest.approx(40e-6)


def test_device_time_by_span(trace):
  by_span = trace_lib.device_seconds_by_span(trace)
  assert by_span['bench.policy'] == pytest.approx(20e-6)
  assert by_span['bench.env_step'] == pytest.approx(30e-6)
  assert trace_lib.span_count(trace, 'bench.policy') == 1


def test_kernel_seconds_by_name(trace):
  assert trace_lib.kernel_seconds(trace, ('noise_chain_kernel',)) == (
      pytest.approx(20e-6), 1)


def test_breakdown_names_the_host_op_in_each_gap(trace):
  out = trace_lib.breakdown(trace)
  assert out['device_ops'][0] == ['sgemm', pytest.approx(20e-6)]
  gaps = dict((round(s * 1e6), name) for name, s in out['idle_gaps'])
  assert gaps == {30: 'aten::item', 20: 'aten::item', 10: 'bench.policy'}
