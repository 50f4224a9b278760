"""Finding a cell's parts by name, so that a new configuration, traffic
mix, driver, check or per-layer metric is new files and entries alone:

  BENCHMARK.json                 the cells and metrics
  benchmark/configs/<name>.json  a configuration (`file` in BENCHMARK.json);
                                 its "checks" name the comparisons, its
                                 model's "kind" the FLOP counter
  benchmark/traffic/<name>.json  a traffic mix; its "driver" names
  benchmark/drivers/<name>.py    the general generator and runner of a kind
  benchmark/checks/<name>.py     a comparison with the plain reference
  benchmark/models/<kind>.py     a model kind's FLOPs a frame, `flops(model)`
  benchmark/metrics/<name>.py    a per-layer metric's reader, `read(ctx)`
  benchmark/limits/<cell>.json   each compared number's limit in a cell

A driver module has `setup(cell, seed, device) -> session`; the session
has `run_window(seconds, profiler) -> window` (a dict with `seconds`,
`attempted`, `failed`, `end_to_end`: the values by metric name, and
`summary`), `samples()`, `expected_samples()`, `release()` and
`trace_context(samples) -> dict`, what the cell's per-layer readers read
besides the trace. It starts and stops the profiler it is handed around
the part of the window it traces, inside a `bench.window` span.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
  name: str
  root: str
  workload: dict
  config: dict
  traffic: dict
  limits: dict
  end_to_end: list
  per_layer: list


def _json(path: str) -> dict:
  with open(path) as f:
    return json.load(f)


def applies(metric: dict, cell: str) -> bool:
  return 'workloads' not in metric or cell in metric['workloads']


def load_cell(name: str, root: str = ROOT) -> Cell:
  spec = _json(os.path.join(root, 'BENCHMARK.json'))
  workloads = {w['name']: w for w in spec['workloads']}
  if name not in workloads:
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')
  workload = workloads[name]
  config_entry = {c['name']: c for c in spec['configs']}[workload['config']]
  bench = os.path.join(root, 'benchmark')
  config = _json(os.path.join(root, config_entry['file']))
  traffic = _json(os.path.join(bench, 'traffic', workload['traffic'] + '.json'))
  limits_path = os.path.join(bench, 'limits', name + '.json')
  limits = _json(limits_path) if os.path.exists(limits_path) else {}
  return Cell(
      name=name, root=root, workload=workload, config=config, traffic=traffic,
      limits=limits,
      end_to_end=[m for m in spec['end_to_end'] if applies(m, name)],
      per_layer=[m for m in spec['per_layer'] if applies(m, name)])


def load_module(kind: str, name: str, root: str = ROOT):
  """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
  path = os.path.join(root, 'benchmark', kind, name + '.py')
  spec = importlib.util.spec_from_file_location(
      f'benchmark_{kind}_{name.replace(".", "_").replace("-", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  sys.modules[spec.name] = module
  spec.loader.exec_module(module)
  return module
