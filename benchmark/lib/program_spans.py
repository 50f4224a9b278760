"""The program's own spans in a trace, and what they say about the device.

putting_dune_torch opens `<layer>.<stage>` spans (`utils/profiling.span`)
while a profiler records: `eval_loop`, `policy`, `env_step`, `kmc` and
`render` name the program's layers, and `sync.<site>` brackets one read of
a device value on the host. Here, within `bench.window`:

- the loop steps: the `eval_loop.step` spans that start in the window (the
  window closes inside the last traced step, after its env step returns,
  so that step's span ends after the window);
- the count of each span name: `kmc.round` counts KMC event rounds and the
  `sync.*` spans count host syncs, where they happen;
- the device seconds of the kernels, copies and memsets launched under
  each span name: a launch goes to the innermost program span whose host
  interval holds it, as `trace.span_of_launch` does for the `bench.*`
  spans;
- the device's idle time by innermost span: each part of an idle interval
  goes to the innermost program span over it that is not a `sync.*` span
  (a sync's part to its parent). A part under no program span, under one
  of the benchmark's own `bench.*` proxies and none of the program's
  spans inside it, or under a bare `eval_loop.step` (the loop's calls
  through the proxies: the loop's own work is in `eval_loop.setup` and
  `eval_loop.accounting`), goes to `outside_program`, keyed
  `outside_program.<span>` where a span covers it. Summed by layer, the
  parts give the six `*.idle_ms` metrics and add up to the idle time.

The harness's recorders still count as the program's where they run
inside its spans: on a recorded step the draw recorder's dispatch, the
rate calls' copies (`kmc.round`) and the logits' copy
(`policy.detector`), and the first call's reset under the draw recorder
(`env_step.step`).

A trace with no `eval_loop.step` span (a program without the spans) gives
None, and the readers of these metrics report nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math

from benchmark.lib import trace as trace_lib

LAYERS = ('eval_loop', 'policy', 'env_step', 'kmc', 'render')
SYNC = 'sync'
OUTSIDE = 'outside_program'
LOOP_STEP = 'eval_loop.step'


@dataclasses.dataclass
class ProgramSpans:
  steps: int                # loop steps in the window
  counts: dict              # span name -> spans that start in the window
  device_s: dict            # span name -> device seconds launched under it
  idle_by_span: dict        # innermost span name (see above) -> idle seconds

  @property
  def idle_s(self) -> dict:
    """Idle seconds by layer, and under OUTSIDE."""
    out = dict.fromkeys(LAYERS + (OUTSIDE,), 0.0)
    for name, seconds in self.idle_by_span.items():
      out[layer_of(name)] += seconds
    return out


def layer_of(name: str) -> str:
  return name.split('.', 1)[0]


def is_program_span(name: str) -> bool:
  return '.' in name and layer_of(name) in LAYERS + (SYNC,)


def segments(spans, label_of) -> list:
  """The innermost span's label over time, as sorted, disjoint (start,
  end, label) pieces; no piece where no span is open. `spans` are (start,
  end, name) and nest; a span that overruns its parent is cut at the
  parent's end. `label_of(name, parent_label)` labels a span, with None
  for the parent of an outermost one."""
  out = []
  stack = []  # [end, label], ends not increasing
  now = -math.inf

  def advance(t):
    nonlocal now
    while stack and stack[-1][0] <= t:
      end, label = stack.pop()
      if end > now:
        out.append((now, end, label))
        now = end
    if stack and t > now:
      out.append((now, t, stack[-1][1]))
    now = max(now, t)

  for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
    advance(start)
    parent = stack[-1][1] if stack else None
    if stack:
      end = min(end, stack[-1][0])
    stack.append([end, label_of(name, parent)])
  advance(math.inf)
  return out


def label_at(pieces, starts, t):
  """The label of the piece that holds time t, or None."""
  i = bisect.bisect_right(starts, t) - 1
  if i >= 0 and pieces[i][1] >= t:
    return pieces[i][2]
  return None


def overlap_by_label(intervals, pieces) -> collections.Counter:
  """Seconds x 1e6 of sorted, disjoint (start, end) intervals under each
  piece's label; None for the part under no piece."""
  out = collections.Counter()
  j = 0
  for a, b in intervals:
    while j < len(pieces) and pieces[j][1] <= a:
      j += 1
    covered = 0.0
    k = j
    while k < len(pieces) and pieces[k][0] < b:
      start, end, label = pieces[k]
      part = min(b, end) - max(a, start)
      if part > 0:
        out[label] += part
        covered += part
      k += 1
    out[None] += (b - a) - covered
  return out


def _attribution(name, parent):
  if name.startswith('bench.') or name == LOOP_STEP:
    return f'{OUTSIDE}.{name}'
  if layer_of(name) == SYNC:
    return parent or OUTSIDE
  return name


def idle_intervals(trace) -> list:
  """The window's stretches in which the device ran nothing."""
  lo, hi = trace.window
  out, t = [], lo
  for start, end in trace_lib.union(trace.device):
    if start > t:
      out.append((t, min(start, hi)))
    t = max(t, end)
    if t >= hi:
      break
  if t < hi:
    out.append((t, hi))
  return [(a, b) for a, b in out if b > a]


def analyse(trace) -> ProgramSpans | None:
  lo, hi = trace.window
  program = [op for op in trace.host_ops
             if is_program_span(op[2]) and op[1] > lo and op[0] < hi]
  counts = collections.Counter(name for start, _, name in program
                               if lo <= start <= hi)
  steps = counts.get(LOOP_STEP, 0)
  if not steps:
    return None

  named = segments(program, lambda name, parent: name)
  starts = [p[0] for p in named]
  device = collections.Counter()
  for start, end, _, corr in trace.device:
    ts = trace.launches.get(corr)
    if ts is not None:
      device[label_at(named, starts, ts)] += (end - start) * 1e-6
  device.pop(None, None)

  proxies = [s for s in trace.spans if s[2] != 'bench.window']
  attributed = segments(program + proxies, _attribution)
  idle = overlap_by_label(idle_intervals(trace), attributed)
  idle[OUTSIDE] += idle.pop(None, 0.0)
  idle_by_span = {name: us * 1e-6 for name, us in idle.most_common()}
  return ProgramSpans(steps, dict(counts), dict(device), idle_by_span)


def read(ctx) -> ProgramSpans | None:
  """The analysis of ctx['trace'], made once a run and kept in ctx."""
  if ctx.get('trace') is None:
    return None
  if 'program_spans' not in ctx:
    ctx['program_spans'] = analyse(ctx['trace'])
  return ctx['program_spans']


def per_step_ms(seconds: float, spans: ProgramSpans) -> float:
  return seconds / spans.steps * 1e3
