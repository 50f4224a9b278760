"""End-to-end check of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card name and power limit; CUDA must be available;
  2. build every CUDA kernel of the main path from csrc/ (nvcc, parallel);
  3. noise_chain against its plain twin at (100, 512, 512): injected draws
     element-wise (max |d| <= 1e-5), in-kernel Philox draws in distribution;
  4. clahe_hist_lut + clahe_remap against their twins at (100, 512, 512),
     grid 8: histograms equal, max |d| <= 2e-5;
  5. each kernel timed (CUDA events, median of 30 launches) beside its
     twin and its bound;
  6. the main path: `ppo_simple_images_tf` on small_eval (100 seeds, 512^2
     render) through the port's eval entry point on CUDA; success >= 0.95,
     average actions within 30.09 +- 6 (the JAX package's eval.json), every
     kernel launched;
  7. `greedy_simple_rates` on tiny_eval reaches the goal every time;
  8. a `kernels` JSON line; 9. the result JSON line, last.

It imports nothing of JAX or of putting_dune_tpu (the shipped weights are
read as data).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and f32
# throughput outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations per pixel of the noise chain as the kernel runs it:
# Poisson inversion (exp + 12 x 5) ~65, three renorm divides, S&P 2,
# gamma 3, uniform 2, exponential 3, Gaussian 4, three max steps, plus
# Box-Muller (log, sqrt, cos, sin, 4 mul) ~8 — about 96.
NOISE_OPS_PER_PIXEL = 96
# clahe_hist_lut: scale, cast, clamp, shared atomic add per pixel.
HIST_OPS_PER_PIXEL = 4
# clahe_remap: bin (3), indices and weights (~12), 4 mul + 3 add.
REMAP_OPS_PER_PIXEL = 22

TPU_SITES = {
    'noise_chain': 'putting_dune_tpu/ops/noise_fused_pallas.py:303',
    'clahe_hist_lut': 'putting_dune_tpu/ops/clahe_fused_pallas.py:579',
    'clahe_remap': 'putting_dune_tpu/ops/clahe_fused_pallas.py:647',
}


def fail(msg: str) -> None:
  print(f'FAIL: {msg}', flush=True)
  sys.exit(1)


def check(cond: bool, msg: str) -> None:
  if not cond:
    fail(msg)


def nvidia_smi_line() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, repeats=30, warmup=3) -> float:
  import torch

  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / F32_OPS_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def main() -> None:
  import torch

  if not torch.cuda.is_available():
    print('FAIL: torch.cuda.is_available() is false', flush=True)
    sys.exit(2)
  smi = nvidia_smi_line()
  print(smi, flush=True)
  print(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}', flush=True)

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.imaging import params as imaging_params
  from putting_dune_torch.ops import _build
  from putting_dune_torch.ops import clahe_fused
  from putting_dune_torch.ops import noise_fused

  dev = torch.device('cuda')
  torch.backends.cuda.matmul.allow_tf32 = False

  # -- 2. build ------------------------------------------------------------
  t0 = time.perf_counter()
  reports = _build.build_all(verbose=True)
  print(f'build: {len(reports)} kernels in {time.perf_counter() - t0:.1f} s',
        flush=True)
  for name, text in reports.items():
    for line in text.splitlines():
      if 'registers' in line or 'spill' in line:
        print(f'  ptxas {name}: {line.strip()}', flush=True)

  _build.reset_launches()
  b, h, w = 100, 512, 512
  npx = b * h * w
  gen = torch.Generator(device=dev).manual_seed(0)

  # -- 3. noise chain ------------------------------------------------------
  params = imaging_params.sample_imaging_params(gen, b, device=dev)
  packed = noise_fused.pack_params(params, b)
  clean = torch.rand((b, h, w), generator=gen, device=dev) ** 4
  draws = noise_fused.sample_draws(gen, b, h, w, dev)
  got = noise_fused.noise_chain(clean, packed, draws=draws)
  want = noise_fused.noise_chain_reference(clean, packed, draws=draws)
  torch.cuda.synchronize()
  noise_err = float((got - want).abs().max())
  print(f'noise_chain injected draws: max|d| = {noise_err:.3g}', flush=True)
  check(noise_err <= 1e-5, f'noise_chain disagrees with its twin: {noise_err}')
  del draws, want

  seeds = torch.randint(0, 2**62, (b,), generator=gen, device=dev)
  philox = noise_fused.noise_chain(clean, packed, seeds=seeds)
  twin = noise_fused.noise_chain_reference(clean, packed, gen=gen)
  check(bool(torch.isfinite(philox).all()), 'noise_chain: non-finite output')
  for stat in ('mean', 'std'):
    sk = getattr(philox, stat)(dim=(1, 2))
    st = getattr(twin, stat)(dim=(1, 2))
    # Same parameters per frame in both: paired per-frame differences.
    d = (sk - st)
    z = float(d.mean() / (d.std() / b ** 0.5 + 1e-12))
    print(f'noise_chain philox vs twin per-frame {stat}: '
          f'mean diff {float(d.mean()):.3g}, z = {z:.2f}', flush=True)
    check(abs(z) < 4.5, f'noise_chain philox {stat} law differs (z={z})')
  flat = torch.full((8, h, w), 0.5, device=dev)
  flat[:, 0, 0] = 1.0
  sp = torch.zeros((8, 8), device=dev)
  sp[:, 0], sp[:, 2], sp[:, 3] = 1e8, 0.2, 1.0
  sp_out = noise_fused.noise_chain(flat, sp, gen=gen)
  salt = float((sp_out > 0.9).float().mean())
  pepper = float((sp_out < 0.1).float().mean())
  print(f'noise_chain philox salt {salt:.4f} pepper {pepper:.4f} '
        '(want 0.1 each)', flush=True)
  check(abs(salt - 0.1) < 0.003 and abs(pepper - 0.1) < 0.003,
        'noise_chain salt & pepper fractions')
  del twin, sp_out

  # -- 4. CLAHE --------------------------------------------------------------
  hist, mapping = clahe_fused.clahe_hist_lut(philox)
  want_hist, want_mapping = clahe_fused.hist_lut_reference(philox)
  check(bool(torch.equal(hist, want_hist)), 'clahe histograms differ')
  out = clahe_fused.clahe_remap(philox, mapping)
  want_out = clahe_fused.clahe_reference(philox)
  torch.cuda.synchronize()
  map_err = float((mapping - want_mapping).abs().max())
  clahe_err = float((out - want_out).abs().max())
  remap_err = float((out - clahe_fused.remap_reference(philox, mapping))
                    .abs().max())
  print(f'clahe: histograms equal, mapping max|d| = {map_err:.3g}, '
        f'output max|d| = {clahe_err:.3g} (remap alone {remap_err:.3g})',
        flush=True)
  check(clahe_err <= 2e-5 and map_err <= 2e-5, 'clahe disagrees with twin')
  del want_out, want_hist, want_mapping

  # -- 5. timing -----------------------------------------------------------
  rows = {}
  t_noise = time_ms(lambda: noise_fused.noise_chain(clean, packed,
                                                    seeds=seeds))
  t_noise_plain = time_ms(lambda: noise_fused.noise_chain_reference(
      clean, packed, gen=gen), repeats=20)
  rows['noise_chain'] = (t_noise, t_noise_plain, noise_err,
                         *bound(8.0 * npx + packed.numel() * 4 + b * 8,
                                NOISE_OPS_PER_PIXEL * npx),
                         'putting_dune_torch/csrc/noise_chain.cu')
  t_hist = time_ms(lambda: clahe_fused.clahe_hist_lut(philox))
  t_hist_plain = time_ms(lambda: clahe_fused.hist_lut_reference(philox),
                         repeats=20)
  rows['clahe_hist_lut'] = (t_hist, t_hist_plain, map_err,
                            *bound(4.0 * npx + hist.numel() * 8,
                                   HIST_OPS_PER_PIXEL * npx),
                            'putting_dune_torch/csrc/clahe_hist_lut.cu')
  t_remap = time_ms(lambda: clahe_fused.clahe_remap(philox, mapping))
  t_remap_plain = time_ms(
      lambda: clahe_fused.remap_reference(philox, mapping), repeats=20)
  rows['clahe_remap'] = (t_remap, t_remap_plain, remap_err,
                         *bound(8.0 * npx + mapping.numel() * 4,
                                REMAP_OPS_PER_PIXEL * npx),
                         'putting_dune_torch/csrc/clahe_remap.cu')
  del clean, philox, out, hist, mapping
  torch.cuda.empty_cache()

  # -- 6. main path: pixel policy on small_eval at the 512^2 render --------
  _build.reset_launches()
  torch.cuda.synchronize()
  report = eval_cli.main(eval_cli.Args(
      experiment_name='ppo_simple_images_tf', eval_suite='small_eval',
      device='cuda'))
  torch.cuda.synchronize()
  launches = dict(_build.LAUNCHES)
  agg = report['aggregate']
  steps_run = report['env_steps'] // 100
  print(f"main path ppo_simple_images_tf small_eval: success "
        f"{agg['average_num_times_reached_goal']}, average actions "
        f"{agg['average_num_actions_taken']:.2f}, {report['env_steps']} env "
        f"steps in {report['wall_seconds']:.2f} s = "
        f"{report['env_steps'] / report['wall_seconds']:.1f} env steps/s, "
        f"launches {launches}", flush=True)
  check(agg['average_num_times_reached_goal'] >= 0.95, 'pixel policy success')
  check(abs(agg['average_num_actions_taken'] - 30.09) <= 6.0,
        'pixel policy average actions outside 30.09 +- 6')
  for name in _build.KERNELS:
    check(launches[name] > 0, f'{name} was not launched on the main path')

  # Observation check on a small batch: finite frames of the policy's shape.
  exp = registry.create_eval_experiment('ppo_simple_images_tf')
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=4,
      device='cuda')
  _, ts = env.reset(env_lib.make_generator(0, dev))
  image = ts.observation['image']
  check(tuple(image.shape) == (4, 128, 128, 1), f'image shape {image.shape}')
  check(bool(torch.isfinite(image).all()) and float(image.min()) >= 0.0
        and float(image.max()) <= 1.0 + 1e-6, 'observation image range')

  # -- 7. vector path: greedy ----------------------------------------------
  greedy = eval_cli.main(eval_cli.Args(
      experiment_name='greedy_simple_rates', eval_suite='tiny_eval',
      device='cuda'))
  g_agg = greedy['aggregate']
  print(f"greedy_simple_rates tiny_eval: success "
        f"{g_agg['average_num_times_reached_goal']}, average actions "
        f"{g_agg['average_num_actions_taken']:.2f}", flush=True)
  check(g_agg['average_num_times_reached_goal'] == 1.0, 'greedy success')

  # -- 8. kernels line -------------------------------------------------------
  kernels = []
  for name, (ms, plain_ms, err, bound_ms, bound_by, source) in rows.items():
    per_step = launches[name] / max(steps_run, 1)
    print(f'{name}: {ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}), '
          f'plain twin {plain_ms:.4f} ms, {per_step:.3f} launches per env '
          f'step, at ({b}, {h}, {w}) on {smi}', flush=True)
    kernels.append({
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': TPU_SITES[name], 'launches': launches[name],
        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
    })
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  main()
