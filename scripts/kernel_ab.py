"""Kernels of two checkouts, timed in turns on one card.

  python3 scripts/kernel_ab.py OTHER_ROOT

OTHER_ROOT is another checkout of the repo (for example the parent commit,
unpacked with `git archive`). The script runs its own `--measure ROOT` mode in
a fresh process for OTHER_ROOT, this checkout, this checkout and OTHER_ROOT
(a b b a). Each process imports `putting_dune_torch` from its ROOT, builds
that checkout's kernels from its csrc/, makes the same inputs from seeds and
times clahe_hist_lut, clahe_small and splat_render at the shapes of
chip_smoke.py:

  * clahe_hist_lut on the noise-chain batch of phase 4, (100, 512, 512), and
    on four (128, 256, 256) batches of rand ** 2.5 in turn (phase 8);
  * clahe_small on four (256, 128, 128) batches of rand ** 2.5 in turn
    (phase 8), and beside it the split pair (clahe_hist_lut then
    clahe_remap) on the same batches;
  * splat_render on the atom windows of a multi_dopant_3_vision_planner env
    at batch 100, S = 256 and 512 (phase 11).

For each: the median of 30 calls timed with CUDA events around the call (the
wrapper's host time included, as chip_smoke.py's `ms`) and the device time
alone (chip_smoke.py's `device_ms`: CUPTI through torch.profiler, the mean
launch over 20 calls, summed over the `__global__` functions of ROOT's
csrc/<kernel>.cu, each of which a call launches once; null, "not measured",
unless the profiler recorded every launch). The timing helpers are this
checkout's chip_smoke.py, whichever ROOT is measured. Prints one JSON line
per process, the card's name and power limit, and last a JSON line with both
sides' means. Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
  """This checkout's chip_smoke.py, loaded by path (it imports only the
  standard library at module level)."""
  spec = importlib.util.spec_from_file_location(
      'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def kernel_names(root: str, kernel: str) -> tuple[str, ...]:
  """The `__global__` functions of ROOT's csrc/<kernel>.cu."""
  with open(os.path.join(root, 'putting_dune_torch', 'csrc', f'{kernel}.cu'),
            encoding='utf-8') as f:
    return tuple(re.findall(
        r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(',
        f.read()))


def measure(root: str) -> dict:
  smoke = load_chip_smoke()
  sys.path.insert(0, root)
  import torch

  from putting_dune_torch import registry
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.imaging import params as imaging_params
  from putting_dune_torch.imaging import render as render_lib
  from putting_dune_torch.ops import _build
  from putting_dune_torch.ops import clahe_fused
  from putting_dune_torch.ops import noise_fused
  from putting_dune_torch.ops import splat

  dev = torch.device('cuda')
  _build.build_all(('noise_chain', 'clahe_hist_lut', 'clahe_remap',
                    'clahe_small', 'splat_render'))
  gen = torch.Generator(device=dev).manual_seed(0)
  b = 100
  params = imaging_params.sample_imaging_params(gen, b, device=dev)
  packed = noise_fused.pack_params(params, b)
  clean = torch.rand((b, 512, 512), generator=gen, device=dev) ** 4
  seeds = torch.randint(0, 2**62, (b,), generator=gen, device=dev)
  noisy = noise_fused.noise_chain(clean, packed, seeds=seeds)
  del clean
  skewed = [torch.rand((128, 256, 256), generator=gen, device=dev) ** 2.5
            for _ in range(4)]
  small = [torch.rand((256, 128, 128), generator=gen, device=dev) ** 2.5
           for _ in range(4)]
  result = {'root': root}
  names = {k: kernel_names(root, k)
           for k in ('clahe_hist_lut', 'clahe_remap', 'clahe_small',
                     'splat_render')}
  result['kernel_names'] = names
  for key, fn in (
      ('clahe_hist_lut (100, 512, 512)',
       lambda: clahe_fused.clahe_hist_lut(noisy)),
      ('clahe_hist_lut (128, 256, 256)',
       smoke.rotating(clahe_fused.clahe_hist_lut, skewed))):
    result[key] = {'ms': smoke.time_ms(fn),
                   'device_ms': smoke.device_ms(fn, names['clahe_hist_lut'])}
  for key, fn, kernels in (
      ('clahe_small (256, 128, 128)', clahe_fused.clahe_small,
       names['clahe_small']),
      ('clahe pair (256, 128, 128)',
       lambda x: clahe_fused.clahe_remap(x, clahe_fused.clahe_hist_lut(x)[1]),
       names['clahe_hist_lut'] + names['clahe_remap'])):
    result[key] = {
        'ms': smoke.time_rotating_ms(fn, small),
        'device_ms': smoke.device_ms(smoke.rotating(fn, small), kernels)}
  del small

  md_env = registry.create_multi_dopant_experiment(
      'multi_dopant_3_vision_planner').make_env(b, device=dev)
  state, _ = md_env.reset(env_lib.make_generator(3, dev))
  window, fov = md_env._atom_window(state), md_env._fov(state)
  for size in (256, 512):
    ops = [t.contiguous() for t in render_lib._splat_inputs(
        window, fov, state.imaging.intensity_exponent, size,
        state.imaging.blur_amount)]
    fn = lambda: splat.splat_render(*ops, image_size=size)  # noqa: E731
    result[f'splat_render (100, 512, {size})'] = {
        'ms': smoke.time_ms(fn),
        'device_ms': smoke.device_ms(fn, names['splat_render'])}
  return result


def mean_or_none(values):
  """The mean, or None where a run did not measure the value."""
  return None if None in values else statistics.mean(values)


def main() -> None:
  if sys.argv[1:2] == ['--measure']:
    print(json.dumps(measure(sys.argv[2])), flush=True)
    return
  import torch

  if not torch.cuda.is_available():
    print('FAIL: torch.cuda.is_available() is false', flush=True)
    sys.exit(2)
  other = os.path.abspath(sys.argv[1])
  smi = load_chip_smoke().nvidia_smi_line()
  print(smi, flush=True)
  runs = {other: [], ROOT: []}
  for root in (other, ROOT, ROOT, other):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--measure', root],
        capture_output=True, text=True, cwd=root, timeout=600)
    if out.returncode != 0:
      print(out.stdout[-3000:], out.stderr[-3000:], flush=True)
      sys.exit(1)
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    runs[root].append(json.loads(line))
  summary = {}
  for label, root in (('other', other), ('this', ROOT)):
    side = {}
    for key in runs[root][0]:
      if key in ('root', 'kernel_names'):
        continue
      side[key] = {m: mean_or_none([r[key][m] for r in runs[root]])
                   for m in ('ms', 'device_ms')}
    summary[label] = side
  print(json.dumps({'device': smi, 'other': other, 'summary': summary}),
        flush=True)


if __name__ == '__main__':
  main()
