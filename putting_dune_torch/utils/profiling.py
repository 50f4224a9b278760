"""Profiling and throughput instrumentation.

Port of putting_dune_tpu/utils/profiling.py: `trace` records a
torch.profiler trace (CPU and, where there is a card, CUDA activity) into
`logdir` as a Chrome trace, `Throughput` counts items per second after a
warm-up, `timed` is a wall-clock timer. Device work is asynchronous: end
a timed region with `torch.cuda.synchronize()` (or read a value back) so
that it counts the work and not its enqueueing.

`span(name)` marks a stage of the program on the profiler's timeline
while a torch.profiler records, and is a shared no-op otherwise. A span's
name is `<layer>.<stage>`: `eval_loop`, `policy`, `env_step`, `kmc` and
`render` name the program's layers, and a `sync.<site>` span brackets one
host sync (a read of a device value on the host, or a copy from pageable
host memory, which waits for the device), so that a trace counts KMC
rounds and host syncs where they happen and puts the device's idle time
down to the layer that kept the host busy.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
  """`torch.profiler.record_function(name)` while a profiler records, else
  one shared null context: no allocation, no effect on the program."""
  if torch.autograd._profiler_enabled():  # pylint: disable=protected-access
    return torch.profiler.record_function(name)
  return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
  """Profiles the block; writes `logdir`/trace.json (chrome://tracing or
  Perfetto)."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(logdir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class Throughput:
  """Steps/sec (or items/sec) counter with warmup exclusion.

  Usage:
    meter = Throughput(warmup=2)
    for _ in range(n):
      ...run a step...
      meter.tick(items=batch_size)
    print(meter.rate())
  """

  def __init__(self, warmup: int = 1):
    self._warmup = warmup
    self._count = 0
    self._items = 0.0
    self._start: Optional[float] = None

  def tick(self, items: float = 1.0) -> None:
    self._count += 1
    if self._count == self._warmup:
      self._start = time.perf_counter()
      self._items = 0.0
      return
    if self._count > self._warmup:
      self._items += items

  def rate(self) -> float:
    if self._start is None or self._items == 0:
      return 0.0
    return self._items / (time.perf_counter() - self._start)


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[None]:
  """Wall-clock timer; stores seconds into results[label] if given, else
  prints them."""
  t0 = time.perf_counter()
  try:
    yield
  finally:
    dt = time.perf_counter() - t0
    if results is not None:
      results[label] = dt
    else:
      print(f'{label}: {dt:.3f}s')
