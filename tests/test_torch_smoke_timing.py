"""chip_smoke.py's device-time reading: a kernel the profiler did not record
on every call makes the reading "not measured", never a smaller sum."""

import importlib.util
import pathlib
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
  spec = importlib.util.spec_from_file_location(
      'chip_smoke', REPO / 'chip_smoke.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _event(key, count, total_us):
  return types.SimpleNamespace(key=key, count=count,
                               device_time_total=total_us)


# Profiler averages of 20 calls of a wrapper that launches two kernels.
_BOTH = [
    _event('void (anonymous namespace)::splat_accumulate_kernel<16>(...)',
           20, 2000.0),
    _event('void (anonymous namespace)::splat_normalize_kernel(...)',
           20, 400.0),
    _event('Memset (Device)', 20, 10.0),
]


@pytest.mark.parametrize('events, want', [
    (_BOTH, 0.12),
    # The accumulate kernel's records were dropped: no reading.
    (_BOTH[1:], None),
    # Some launches were dropped: no reading.
    ([_event(_BOTH[0].key, 17, 1700.0)] + _BOTH[1:], None),
    # A kernel under two keys (two instantiations) counts as one.
    ([_event('splat_accumulate_kernel<8>', 12, 1200.0),
      _event('splat_accumulate_kernel<16>', 8, 800.0)] + _BOTH[1:], 0.12),
])
def test_recorded_device_ms_needs_every_launch(events, want):
  got = _chip_smoke().recorded_device_ms(
      events, ('splat_accumulate_kernel', 'splat_normalize_kernel'), 20)
  assert got == (None if want is None else pytest.approx(want))


def test_smoke_names_every_kernel_it_times_by_device():
  smoke = _chip_smoke()
  for kernel, names in smoke.KERNEL_NAMES.items():
    source = (REPO / smoke.SOURCES[kernel]).read_text()
    for name in names:
      assert f'{name}(' in source, (kernel, name)
