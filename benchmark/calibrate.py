"""Readings the limits of the correctness check are set from.

  python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
      --seconds <s> [--checks transition,episodes] \
      [--out calibrate.jsonl]

Builds the cell's program once, then for each seed runs a window of the
cell's own traffic at its own sizes and prints one JSON line: the numbers
the check compares for the program, and for the control, which puts the
reference computed one precision below the configuration's (float32 ->
TF32, TF32 -> bfloat16; benchmark/reference/precision.py) in the
program's place on the same recorded inputs. The benchmark's runs never
run the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, *, root: str = ROOT, device: str = 'cuda') -> list:
  parser = argparse.ArgumentParser()
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--checks', default=None,
                      help='the checks to read (default: all of the cell\'s)')
  parser.add_argument('--out', default=None)
  args = parser.parse_args(argv)
  if root not in sys.path:
    sys.path.insert(0, root)
  from benchmark import run
  from benchmark.lib import cells

  run._environment()  # pylint: disable=protected-access
  import torch

  if device == 'cuda' and not torch.cuda.is_available():
    raise SystemExit('calibrate: no CUDA device')
  cell = cells.load_cell(args.workload, root)
  if args.checks:
    cell.config = dict(cell.config, checks=args.checks.split(','))
  driver = cells.load_module('drivers', cell.traffic['driver'], root)
  seeds = [int(s) for s in args.seeds.split(',')]
  session = driver.setup(cell, seeds[0], device)
  lines = []
  log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
  for seed in seeds:
    session.reseed(seed)
    t0 = time.perf_counter()
    window = session.run_window(args.seconds)
    samples = session.samples()
    line = {
        'workload': args.workload, 'seed': seed,
        'recorded': len(samples),
        'end_to_end': window['end_to_end'],
        'program': run.compare(cell, samples, False, log),
        'control': run.compare(cell, samples, True, log),
        'seconds': time.perf_counter() - t0}
    if device == 'cuda':
      line['device'] = torch.cuda.get_device_name(0)
    print(json.dumps(line), flush=True)
    lines.append(line)
    if args.out:
      os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
      with open(args.out, 'a') as f:
        f.write(json.dumps(line) + '\n')
    del samples
    session.probe.records.clear()
  return lines


if __name__ == '__main__':
  main()
