"""Which sum of the splat kernel gives the bmm route's frames bit for bit.

  python3 scripts/splat_rounding_probe.py

Builds csrc/splat_render.cu as it is (each atom added by one `fmaf`) and a
variant whose sums round the product before the add (`acc + q * fx`, the
kernel's arithmetic before it took `fmaf`), into putting_dune_torch/_build/.
On the atom windows of a `ppo_simple_images_tf` env at B 1024 (two seeds)
and a `vision_planner_simple_rates` env at B 100, at S = 512, 256 and 128,
it counts the pixels where each kernel differs from the bmm route
(`splat.splat_render_reference`, the frame `backend='bmm'` renders) and from
the benchmark's reference splat (benchmark/reference/render.py, which the
cells' correctness check replays the noise on); at (1024, 512, 512) it also
holds the shipped kernel to `splat_render_atom_order` on 64 frames and
times both kernels (median of 30 calls, CUDA events). Prints one line per
comparison and last a JSON line of the timings. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FMA = 'acc[4 * r4 + {i}] = fmaf(q.{c}, fx, acc[4 * r4 + {i}]);'
MUL_ADD = 'acc[4 * r4 + {i}] = acc[4 * r4 + {i}] + q.{c} * fx;'


def build_mul_add(_build) -> ctypes.CDLL:
  """The variant whose sums round the product, then add."""
  src = (_build.SRC_DIR / 'splat_render.cu').read_text()
  for i, c in enumerate('xyzw'):
    line = FMA.format(i=i, c=c)
    if line not in src:
      raise SystemExit(f'csrc/splat_render.cu has no line {line!r}')
    src = src.replace(line, MUL_ADD.format(i=i, c=c))
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  cu = _build.BUILD_DIR / 'splat_render_mul_add.cu'
  so = _build.BUILD_DIR / 'splat_render_mul_add.so'
  cu.write_text(src)
  subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', str(so),
                  str(cu)], check=True)
  fn = ctypes.CDLL(str(so)).splat_render_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
  return fn


def main() -> None:
  import torch

  from benchmark.reference import render as reference
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch import simulator as simulator_lib
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.imaging import render as render_lib
  from putting_dune_torch.ops import _build
  from putting_dune_torch.ops import splat

  dev = torch.device('cuda')
  mul_add_fn = build_mul_add(_build)

  def mul_add(bx, by, w, sx, sy, s):
    out = torch.empty((bx.shape[0], s, s), device=dev)
    status = mul_add_fn(
        _build.ptr(bx), _build.ptr(by), _build.ptr(w), _build.ptr(sx),
        _build.ptr(sy), _build.ptr(out), bx.shape[0], bx.shape[1], s,
        _build.stream_ptr(dev))
    _build.check_status('splat_render_mul_add', status)
    return out

  def report(label, got, want):
    d = (got - want).abs()
    frames = int((d.flatten(1).amax(1) > 0).sum())
    print(f'  {label}: {int((d > 0).sum())} of {d.numel()} pixels differ, '
          f'in {frames} of {d.shape[0]} frames, max|d| {float(d.max()):.3g}',
          flush=True)

  def time_ms(fn):
    for _ in range(3):
      fn()
    times = []
    for _ in range(30):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end))
    return statistics.median(times)

  timings = {}
  for name, batch, seed in (('ppo_simple_images_tf', 1024, 11),
                            ('vision_planner_simple_rates', 100, 12),
                            ('ppo_simple_images_tf', 1024, 13)):
    exp = registry.create_eval_experiment(name)
    env = run_helpers.create_batched_env(
        exp.get_adapters_and_goal, exp.get_simulator_config,
        batch_size=batch, image_size=512, device=dev)
    state, _ = env.reset(env_lib.make_generator(seed, dev))
    fov = state.sim.fov.shift(-state.sim.drift)
    window = simulator_lib.atom_window(env.lattice, state.sim.material, fov,
                                       env.config.sim.window_capacity)
    imaging = state.sim.imaging
    z = torch.where(window.mask, window.atomic_numbers,
                    torch.zeros_like(window.atomic_numbers))
    for s in (512, 256, 128):
      print(f'{name} B {batch} seed {seed} S {s}', flush=True)
      ops = [t.contiguous() for t in render_lib._splat_inputs(
          window, fov, imaging.intensity_exponent, s, imaging.blur_amount)]
      bmm = splat.splat_render_reference(*ops, image_size=s)
      refs = torch.cat([reference.splat(
          window.positions[i:i + 128], z[i:i + 128], fov.width[i:i + 128],
          fov.height[i:i + 128], imaging.intensity_exponent[i:i + 128],
          imaging.blur_amount[i:i + 128], s) for i in range(0, batch, 128)])
      fma = splat.splat_render(*ops, image_size=s)
      old = mul_add(*ops, s)
      torch.cuda.synchronize()
      report('bmm route vs the benchmark reference', bmm, refs)
      report('kernel (fmaf) vs the bmm route', fma, bmm)
      report('kernel (fmaf) vs the benchmark reference', fma, refs)
      report('kernel (mul, add) vs the bmm route', old, bmm)
      report('kernel (mul, add) vs the benchmark reference', old, refs)
      if s == 512 and seed == 11:
        oracle = splat.splat_render_atom_order(
            *[t[:64] for t in ops], image_size=s)
        report('kernel (fmaf) vs splat_render_atom_order, 64 frames',
               fma[:64], oracle)
        del oracle
        timings = {
            'shape': [batch, 512, s],
            'fmaf_ms': time_ms(lambda: splat.splat_render(*ops, image_size=s)),
            'mul_add_ms': time_ms(lambda: mul_add(*ops, s))}
        print(f'  call at (1024, 512, 512): fmaf {timings["fmaf_ms"]:.4f} ms, '
              f'mul-add {timings["mul_add_ms"]:.4f} ms', flush=True)
      del bmm, refs, fma, old
      torch.cuda.empty_cache()
  print(json.dumps(timings), flush=True)


if __name__ == '__main__':
  main()
