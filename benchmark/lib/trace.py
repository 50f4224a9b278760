"""Reading a torch.profiler chrome trace: device intervals, the benchmark's
spans, kernels by name and by the span that launched them, the device's
busy time as the union of its intervals, and the breakdown."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


@dataclasses.dataclass
class Trace:
  window: tuple            # (start, end) of the 'bench.window' span, us
  device: list             # (start, end, name, correlation), us
  launches: dict           # correlation -> host time of the launch call, us
  spans: list              # (start, end, name) of 'bench.*' spans, us
  host_ops: list           # (start, end, name) of the host's op events, us


def load(path: str) -> Trace:
  with open(path) as f:
    data = json.load(f)
  events = data['traceEvents'] if isinstance(data, dict) else data
  device, spans, host_ops, launches = [], [], [], {}
  window = None
  for e in events:
    if e.get('ph') != 'X':
      continue
    cat, name = e.get('cat', ''), e.get('name', '')
    ts, dur = float(e['ts']), float(e.get('dur', 0.0))
    args = e.get('args') or {}
    if cat in DEVICE_CATS:
      device.append((ts, ts + dur, name, args.get('correlation')))
    elif cat in ('cuda_runtime', 'cuda_driver'):
      if 'correlation' in args:
        launches[args['correlation']] = ts
    elif cat == 'user_annotation' and name.startswith('bench.'):
      if name == 'bench.window':
        window = (ts, ts + dur)
      else:
        spans.append((ts, ts + dur, name))
        host_ops.append((ts, ts + dur, name))
    elif cat in ('cpu_op', 'user_annotation', 'python_function'):
      host_ops.append((ts, ts + dur, name))
  if window is None:
    raise ValueError(f'{path}: no bench.window span in the trace')
  device = [d for d in device if d[1] > window[0] and d[0] < window[1]]
  device.sort()
  spans.sort()
  host_ops.sort()
  return Trace(window, device, launches, spans, host_ops)


def union(intervals) -> list:
  """Merged (start, end) intervals of the given ones."""
  merged = []
  for start, end in sorted((i[0], i[1]) for i in intervals):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return [tuple(m) for m in merged]


def busy_seconds(trace: Trace) -> float:
  lo, hi = trace.window
  return sum(min(e, hi) - max(s, lo) for s, e in union(trace.device)) * 1e-6


def window_seconds(trace: Trace) -> float:
  return (trace.window[1] - trace.window[0]) * 1e-6


def span_of_launch(trace: Trace, correlation) -> str | None:
  """The innermost 'bench.*' span whose host interval holds the launch."""
  ts = trace.launches.get(correlation)
  if ts is None:
    return None
  found = None
  for start, end, name in trace.spans:
    if start > ts:
      break
    if end >= ts:
      found = name
  return found


def device_seconds_by_span(trace: Trace) -> dict:
  out = collections.Counter()
  for start, end, _, corr in trace.device:
    out[span_of_launch(trace, corr)] += (end - start) * 1e-6
  return dict(out)


def span_count(trace: Trace, name: str) -> int:
  return sum(1 for s in trace.spans if s[2] == name)


def kernel_seconds(trace: Trace, names) -> tuple[float, int]:
  """Summed device seconds and launch count of kernels whose name holds
  any of `names`."""
  total, count = 0.0, 0
  for start, end, name, _ in trace.device:
    if any(n in name for n in names):
      total += (end - start) * 1e-6
      count += 1
  return total, count


def breakdown(trace: Trace, top: int = 10) -> dict:
  """The device operations that took most time, and the longest idle
  gaps in the window, each named by the host op running at its middle."""
  ops = collections.Counter()
  for start, end, name, _ in trace.device:
    ops[name[:120]] += (end - start) * 1e-6
  lo, hi = trace.window
  busy = union(trace.device)
  edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
  gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                 for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                reverse=True)[:top]
  starts = [op[0] for op in trace.host_ops]
  named = []
  for length, start in gaps:
    mid = start + length / 2
    host = 'none'
    for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
      op = trace.host_ops[j]
      if op[1] >= mid:
        host = op[2][:120]
        break
      if mid - op[0] > 5e6:
        break
    named.append([host, length * 1e-6])
  return {'device_ops': [[n, s] for n, s in ops.most_common(top)],
          'idle_gaps': named}
