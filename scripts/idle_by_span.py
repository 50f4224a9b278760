"""A benchmark cell's traced window, with the device's idle time and
device time a loop step by the program's innermost span.

  python scripts/idle_by_span.py <workload> <seed>

Sets the cell up and traces its window as `benchmark/run.py --trace 1`
does (the first call's first `traced_steps` env steps), then prints, and
writes to `chiprun_out/idle_by_span_<workload>.json`, what
`benchmark/lib/program_spans.analyse` reads there, each a loop step: the
device's idle time by innermost span, the device time by the innermost
span of each launch, and the span counts. On the card only.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> None:
  sys.path.insert(0, ROOT)
  import torch

  from benchmark.lib import cells
  from benchmark.lib import program_spans as ps
  from benchmark.lib import trace as trace_lib

  workload, seed = argv[0], int(argv[1])
  cell = cells.load_cell(workload, ROOT)
  driver = cells.load_module('drivers', cell.traffic['driver'], ROOT)
  session = driver.setup(cell, seed, 'cuda')
  profiler = torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA])
  window = session.run_window(5.0, profiler)
  path = os.path.join(tempfile.mkdtemp(), 'trace.json')
  profiler.export_chrome_trace(path)
  trace = trace_lib.load(path)
  os.remove(path)
  spans = ps.analyse(trace)
  lo, hi = trace.window
  steps = spans.steps
  out = {
      'workload': workload, 'steps': steps,
      'window_ms_per_step': (hi - lo) / steps / 1e3,
      'idle_ms_per_step': {k: v / steps * 1e3
                           for k, v in spans.idle_by_span.items()},
      'device_ms_per_step': {k: v / steps * 1e3 for k, v in sorted(
          spans.device_s.items(), key=lambda kv: -kv[1])},
      'counts_per_step': {k: v / steps
                          for k, v in sorted(spans.counts.items())},
      'summary': window['summary']}
  print(json.dumps(out, indent=1))
  os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
  with open(os.path.join(ROOT, 'chiprun_out',
                         f'idle_by_span_{workload}.json'), 'w') as f:
    json.dump(out, f, indent=1)


if __name__ == '__main__':
  main(sys.argv[1:])
