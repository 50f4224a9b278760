"""Runs one cell of the benchmark of putting_dune_torch once.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Reads the cell from BENCHMARK.json, builds the program through its own
entry points (set-up: imports, the CUDA kernels built once into the
checkout, weights, one warm-up at the cell's shapes), runs the measured
window, then holds what the timed path produced against the plain
reference in benchmark/reference/. The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`,
with --trace 1 `breakdown`, and last `checks`, each compared number
beside its limit (also the last lines of standard error).

Exits non-zero with no result when CUDA is absent or has fewer devices
than the cell asks for, and when JAX, flax or the JAX package were loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
  """Keeps libraries that could load JAX by themselves from doing so."""
  os.environ['USE_FLAX'] = '0'
  os.environ['USE_JAX'] = '0'


def _parse(argv):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def _power_limit_w():
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader,'
         'nounits', '-i', '0'], capture_output=True, text=True, timeout=20)
    return float(out.stdout.strip().splitlines()[0])
  except (OSError, ValueError, IndexError, subprocess.SubprocessError):
    return None


def compare(cell, samples, control: bool, log) -> dict:
  """Every number the cell's checks compare: the program's recorded
  outputs, or with `control` the reference one precision below, against
  the reference."""
  from benchmark.lib import cells

  numbers = {}
  for name in cell.config['checks']:
    module = cells.load_module('checks', name, cell.root)
    try:
      numbers.update(module.compare(samples, cell.config, cell.traffic,
                                    control))
    except Exception as e:  # pylint: disable=broad-except
      log(f'check {name} could not compare: {type(e).__name__}: {e}')
      numbers[f'{name}_compared'] = math.inf
  return numbers


def _trace_context(profiler, workdir):
  from benchmark.lib import trace as trace_lib

  path = os.path.join(workdir, 'trace.json')
  profiler.export_chrome_trace(path)
  try:
    return trace_lib.load(path), os.path.getsize(path)
  finally:
    os.remove(path)


def run(argv=None, *, root: str = ROOT, device: str = 'cuda',
        out=sys.stdout, log=None) -> int:
  """One run; returns the exit code. `device='cpu'` (tests only) skips
  the look for a card."""
  _environment()
  log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
  args = _parse(argv)
  if root not in sys.path:
    sys.path.insert(0, root)
  from benchmark.lib import cells
  from benchmark.lib import guard

  cell = cells.load_cell(args.workload, root)
  import torch

  chips = int(cell.workload['chips'])
  if device == 'cuda' and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < chips):
    log(f'{args.workload} needs {chips} CUDA device(s); found '
        f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}.')
    return 2
  torch.backends.cudnn.benchmark = False
  driver = cells.load_module('drivers', cell.traffic['driver'], root)
  imported_s = time.perf_counter() - _START
  session = driver.setup(cell, args.seed, device)
  setup_s = time.perf_counter() - _START
  log(f'set-up {setup_s} s: imports {imported_s} s, then '
      f'{getattr(session, "setup_seconds", {})}')

  profiler = None
  if args.trace:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == 'cuda':
      activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
  window = session.run_window(args.seconds, profiler)
  memory_peak = (torch.cuda.max_memory_allocated() if device == 'cuda'
                 else 0)
  samples = session.samples()
  wanted = session.expected_samples()
  session.release()

  numbers = compare(cell, samples, False, log)
  if len(samples) != wanted:
    log(f'recorded {len(samples)} of {wanted} samples')
    numbers['recorded_steps_missing'] = float(wanted - len(samples))
  limits = dict(cell.limits)
  # A check that could not compare, and a sample that never came, fail:
  # their numbers are held to 0.
  for name in numbers:
    if name.endswith('_compared') or name == 'recorded_steps_missing':
      limits.setdefault(name, 0.0)
  correct = bool(numbers) and all(
      name in limits and value <= limits[name]
      for name, value in numbers.items())

  result = {'correct': correct, 'attempted': int(window['attempted']),
            'failed': int(window['failed'])}
  if device == 'cuda':
    result['device'] = {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': chips, 'memory_peak_bytes': int(memory_peak),
        'power_limit_w': _power_limit_w()}
  else:
    result['device'] = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                        'memory_peak_bytes': 0}

  if not args.trace:
    values = dict(window['end_to_end'], setup_s=setup_s)
    missing = [m['name'] for m in cell.end_to_end if m['name'] not in values]
    if missing:
      log(f'the driver {cell.traffic["driver"]} gave no value for '
          f'{", ".join(missing)}')
      return 4
    metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
               for m in cell.end_to_end}
  else:
    from benchmark.lib import trace as trace_lib

    workdir = tempfile.mkdtemp(prefix='bench-trace-')
    try:
      trace, trace_bytes = _trace_context(profiler, workdir)
    finally:
      shutil.rmtree(workdir, ignore_errors=True)
    ctx = dict(session.trace_context(samples), trace=trace,
               window_s=window['seconds'])
    metrics = {}
    for m in cell.per_layer:
      value = cells.load_module('metrics', m['name'], root).read(ctx)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result['device']['busy_s'] = trace_lib.busy_seconds(trace)
    result['device']['window_s'] = trace_lib.window_seconds(trace)
    result['breakdown'] = trace_lib.breakdown(trace)
    log(f'traced run: end to end {window["end_to_end"]}, a trace of '
        f'{trace_bytes} bytes')
  result['metrics'] = metrics
  result['checks'] = {name: {'value': value, 'limit': limits.get(name)}
                      for name, value in numbers.items()}

  loaded = guard.forbidden_loaded()
  if loaded:
    log(f'forbidden modules loaded: {", ".join(loaded)}')
    return 3
  log(f'window {window["seconds"]} s: {window["summary"]}; set-up '
      f'{setup_s} s; end to end {window["end_to_end"]}')
  for name, value in numbers.items():
    log(f'check {name}: {value} (limit {limits.get(name)})')
  print(json.dumps(result), file=out, flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(run())
