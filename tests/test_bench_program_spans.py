"""The benchmark's readers of the program's spans
(benchmark/lib/program_spans.py and its metrics), on a synthetic chrome
trace: kernels by innermost program span, the device's idle time by
layer, and nothing read from a program without spans."""

import json

import pytest

from benchmark.lib import cells
from benchmark.lib import program_spans
from benchmark.lib import trace as trace_lib

IDLE_METRICS = ('eval_loop', 'policy', 'env_step', 'kmc', 'render',
                'outside_program')
NEW_METRICS = ('kmc.rounds_per_step', 'host_sync.per_step',
               'render.splat.device_ms', 'policy.detector.device_ms',
               'render.splat.fused_share') + tuple(
                   f'{name}.idle_ms' for name in IDLE_METRICS)


def _span(name, ts, dur):
  return {'cat': 'user_annotation', 'name': name, 'ts': ts, 'dur': dur}


def _launch(ts, corr):
  return {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': ts,
          'dur': 0.5, 'args': {'correlation': corr}}


def _kernel(name, ts, dur, corr):
  return {'cat': 'kernel', 'name': name, 'ts': ts, 'dur': dur,
          'args': {'correlation': corr}}


# One loop step in a 200 us window, then 100 us with no program span:
#   eval_loop.step 0-100
#     bench.policy 5-30 > policy.step 6-29 > policy.detector 8-20
#     bench.env_step 30-90 > env_step.step 31-89
#       kmc.apply_control 32-60 > sync.kmc_active 33-40, kmc.round 40-50
#       render.splat 60-80
#     eval_loop.accounting 90-100
# Kernels: 8-12 (launched in policy.detector), 12-33 (policy.step),
# 40-45 (kmc.round), 62-80 (render.splat); idle 0-8, 33-40, 45-62, 80-200.
EVENTS = [
    _span('bench.window', 0, 200),
    _span('eval_loop.step', 0, 100),
    _span('bench.policy', 5, 25),
    _span('policy.step', 6, 23),
    _span('policy.detector', 8, 12),
    _span('bench.env_step', 30, 60),
    _span('env_step.step', 31, 58),
    _span('kmc.apply_control', 32, 28),
    _span('sync.kmc_active', 33, 7),
    _span('kmc.round', 40, 10),
    _span('render.splat', 60, 20),
    _span('eval_loop.accounting', 90, 10),
    {'cat': 'cpu_op', 'name': 'aten::mul', 'ts': 120, 'dur': 5},
    _launch(9, 1), _launch(21, 2), _launch(41, 3), _launch(61, 4),
    _kernel('unet_conv', 8, 4, 1),
    _kernel('lattice_frame', 12, 21, 2),
    _kernel('kmc_where', 40, 5, 3),
    _kernel('splat_sgemm', 62, 18, 4),
]


def _load(tmp_path, events):
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': [
      dict(ph='X', **e) for e in events]}))
  return trace_lib.load(str(path))


@pytest.fixture
def spans(tmp_path):
  return program_spans.analyse(_load(tmp_path, EVENTS))


def test_a_kernel_goes_to_its_innermost_program_span(spans):
  assert spans.steps == 1
  assert spans.device_s == pytest.approx({
      'policy.detector': 4e-6, 'policy.step': 21e-6, 'kmc.round': 5e-6,
      'render.splat': 18e-6})


def test_a_sync_spans_idle_time_goes_to_its_parents_layer(spans):
  # 33-40 under sync.kmc_active goes to the KMC; 45-50 under kmc.round,
  # 50-60 under kmc.apply_control.
  assert spans.idle_s['kmc'] == pytest.approx(22e-6)
  # 60-62, before the splat's kernel.
  assert spans.idle_s['render'] == pytest.approx(2e-6)
  # 90-100 (eval_loop.accounting); 6-8 the policy's.
  assert spans.idle_s['eval_loop'] == pytest.approx(10e-6)
  assert spans.idle_s['policy'] == pytest.approx(2e-6)
  # 80-89 under env_step.step.
  assert spans.idle_s['env_step'] == pytest.approx(9e-6)
  # 0-5 under a bare eval_loop.step (the loop's calls through the
  # proxies), 5-6 in bench.policy alone, 89-90 in bench.env_step alone
  # and 100-200 under no span are outside the program.
  assert spans.idle_s['outside_program'] == pytest.approx(
      5e-6 + 1e-6 + 1e-6 + 100e-6)


def test_idle_time_by_innermost_span_name(spans):
  assert spans.idle_by_span == pytest.approx({
      'outside_program.eval_loop.step': 5e-6,
      'outside_program.bench.policy': 1e-6,
      'policy.step': 2e-6,
      'kmc.apply_control': 7e-6 + 10e-6,  # 33-40 its sync's, 50-60 its own
      'kmc.round': 5e-6,
      'render.splat': 2e-6,
      'env_step.step': 9e-6,
      'outside_program.bench.env_step': 1e-6,
      'eval_loop.accounting': 10e-6,
      'outside_program': 100e-6})


def test_the_six_idle_parts_sum_to_the_idle_time(tmp_path, spans):
  trace = _load(tmp_path, EVENTS)
  idle = trace_lib.window_seconds(trace) - trace_lib.busy_seconds(trace)
  assert sum(spans.idle_s.values()) == pytest.approx(idle)
  assert set(spans.idle_s) == set(IDLE_METRICS)
  ctx = {'trace': trace}
  read = {name: cells.load_module('metrics', f'{name}.idle_ms').read(ctx)
          for name in IDLE_METRICS}
  assert sum(read.values()) * 1e-3 == pytest.approx(idle)


def test_the_counters_are_spans_a_loop_step(tmp_path):
  # A second step in the window; the window's last step starts in it and
  # ends after it, as when the profiler stops inside the last traced step.
  events = EVENTS + [
      _span('eval_loop.step', 150, 80), _span('kmc.round', 160, 5),
      _span('sync.kmc_active', 155, 2), _span('sync.noise_jitter', 170, 2)]
  ctx = {'trace': _load(tmp_path, events)}
  read = lambda name: cells.load_module('metrics', name).read(ctx)  # noqa: E731
  assert read('kmc.rounds_per_step') == pytest.approx(1.0)
  assert read('host_sync.per_step') == pytest.approx(1.5)
  assert read('render.splat.device_ms') == pytest.approx(9e-3)
  assert read('policy.detector.device_ms') == pytest.approx(2e-3)


def test_the_fused_share_is_splat_kernels_over_splat_spans(tmp_path):
  def read(events):
    ctx = {'trace': _load(tmp_path, events)}
    return cells.load_module('metrics', 'render.splat.fused_share').read(ctx)

  # The batched matrix product's kernels under render.splat.
  assert read(EVENTS) == 0.0
  kernel = 'void (anonymous namespace)::splat_render_kernel<16>(float*)'
  fused = [e for e in EVENTS if e['name'] != 'splat_sgemm'] + [
      _kernel(kernel, 62, 3, 4)]
  assert read(fused) == 1.0
  # A second step whose splat took the matrix product.
  mixed = fused + [_span('eval_loop.step', 150, 80),
                   _span('render.splat', 160, 20), _launch(161, 5),
                   _kernel('splat_sgemm', 162, 10, 5)]
  assert read(mixed) == pytest.approx(0.5)


def test_a_program_without_spans_reports_nothing(tmp_path):
  events = [e for e in EVENTS
            if e['cat'] != 'user_annotation' or e['name'].startswith('bench.')]
  ctx = {'trace': _load(tmp_path, events)}
  for name in NEW_METRICS:
    assert cells.load_module('metrics', name).read(ctx) is None, name
  assert program_spans.read({}) is None


def test_segments_cut_a_span_that_overruns_its_parent():
  pieces = program_spans.segments(
      [(0, 10, 'a'), (2, 12, 'b'), (20, 25, 'c')],
      lambda name, parent: name)
  assert pieces == [(0, 2, 'a'), (2, 10, 'b'), (20, 25, 'c')]
