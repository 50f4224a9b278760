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
  8. the other CLAHE routes: `clahe_small` against `clahe_reference` at
     (256, 128, 128) and at (64, 128, 128) with 128 bins, and against the
     split pair at (8, 128, 128); the pair against its twins at
     (128, 256, 256), (64, 384, 384) and (64, 128, 128) with 128 bins
     (histograms equal, max |d| <= 2e-5); noise_chain with injected draws
     at (128, 256, 256); `clahe_small` and the pair timed with bounds;
  9. path A, generator + detector: `sample_batch` at batch 64, noisy, at
     128^2 (must launch `clahe_small`) and 256^2 (must launch the pair);
     shapes, ranges, one-hot masks; the shipped UNet's pixel accuracy on
     the 256^2 batches (noisy and clean) against `DETECTOR_ACCURACY_BARS`;
     the UNet forward timed at (100, 256, 256, 1), TF32 (the detector's
     default on the card) and full f32;
  10. path B: `vision_planner_simple_rates` on small_eval (512^2 render ->
      256^2 features -> UNet -> lattice frame -> planner), success >= 0.90;
      `planner_simple_rates` on small_eval, success >= 0.95;
  11. a `kernels` JSON line; 12. the result JSON line, last.

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

# Least pixel accuracy of the shipped detector's argmax against the label
# mask on the port's own 256^2 scenes: the JAX package's value on its own
# scenes less 0.02 (0.825 noisy, 0.951 clean; tests/test_torch_detector.py
# measures both packages and holds these bars to that rule).
DETECTOR_ACCURACY_BARS = {'noisy': 0.80, 'clean': 0.93}

# The pallas_call sites each kernel covers (file:line, further lines of
# the same file after commas).
TPU_SITES = {
    'noise_chain': 'putting_dune_tpu/ops/noise_fused_pallas.py:303',
    # Histogram kernels (uint8 nibble :579, int32 nibble :597/:689, one-hot
    # :614/:708) and the LUT kernel (:628/:721).
    'clahe_hist_lut': ('putting_dune_tpu/ops/clahe_fused_pallas.py:579,'
                       '597,614,628,689,708,721'),
    # Natural-layout remap :647 and the dual-block remap of
    # clahe_fused_large :744.
    'clahe_remap': 'putting_dune_tpu/ops/clahe_fused_pallas.py:647,744',
    'clahe_small': 'putting_dune_tpu/ops/clahe_fused_pallas.py:253',
}

SOURCES = {name: f'putting_dune_torch/csrc/{name}.cu' for name in TPU_SITES}


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


def time_rotating_ms(fn, inputs, repeats=30) -> float:
  """Median time of fn(x) over `inputs` in turn: buffers that together
  exceed the 50 MB L2, so each launch finds its frame in device memory."""
  state = {'i': 0}

  def call():
    fn(inputs[state['i'] % len(inputs)])
    state['i'] += 1

  return time_ms(call, repeats=repeats, warmup=len(inputs))


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
                         SOURCES['noise_chain'])
  t_hist = time_ms(lambda: clahe_fused.clahe_hist_lut(philox))
  t_hist_plain = time_ms(lambda: clahe_fused.hist_lut_reference(philox),
                         repeats=20)
  rows['clahe_hist_lut'] = (t_hist, t_hist_plain, map_err,
                            *bound(4.0 * npx + hist.numel() * 8,
                                   HIST_OPS_PER_PIXEL * npx),
                            SOURCES['clahe_hist_lut'])
  t_remap = time_ms(lambda: clahe_fused.clahe_remap(philox, mapping))
  t_remap_plain = time_ms(
      lambda: clahe_fused.remap_reference(philox, mapping), repeats=20)
  rows['clahe_remap'] = (t_remap, t_remap_plain, remap_err,
                         *bound(8.0 * npx + mapping.numel() * 4,
                                REMAP_OPS_PER_PIXEL * npx),
                         SOURCES['clahe_remap'])
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
  print(f"main path ppo_simple_images_tf small_eval: success "
        f"{agg['average_num_times_reached_goal']}, average actions "
        f"{agg['average_num_actions_taken']:.2f}, {report['env_steps']} env "
        f"steps in {report['wall_seconds']:.2f} s = "
        f"{report['env_steps'] / report['wall_seconds']:.1f} env steps/s, "
        f"launches {launches}", flush=True)
  check(agg['average_num_times_reached_goal'] >= 0.95, 'pixel policy success')
  check(abs(agg['average_num_actions_taken'] - 30.09) <= 6.0,
        'pixel policy average actions outside 30.09 +- 6')
  for name in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
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

  path_launches = {'pixel_policy_512': launches}
  other_shapes = {name: [] for name in _build.KERNELS}

  # -- 8. the other CLAHE routes ---------------------------------------------
  def frames(shape):
    return torch.rand(shape, generator=gen, device=dev) ** 2.5

  def hold_small(shape, nbins):
    x = frames(shape)
    out, hist_s = clahe_fused.clahe_small(x, nbins=nbins, return_hist=True)
    want_hist, _ = clahe_fused.hist_lut_reference(x, nbins=nbins)
    want = clahe_fused.clahe_reference(x, nbins=nbins)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    print(f'clahe_small {shape} nbins {nbins}: histograms '
          f'{"equal" if torch.equal(hist_s, want_hist) else "DIFFER"}, '
          f'max|d| = {err:.3g}', flush=True)
    check(bool(torch.equal(hist_s, want_hist)),
          f'clahe_small histograms differ at {shape}')
    check(err <= 2e-5, f'clahe_small disagrees with its twin at {shape}')
    return x, err

  def hold_pair(shape, nbins):
    x = frames(shape)
    hist_p, mapping_p = clahe_fused.clahe_hist_lut(x, nbins=nbins)
    out = clahe_fused.clahe_remap(x, mapping_p)
    want_hist, want_mapping = clahe_fused.hist_lut_reference(x, nbins=nbins)
    want = clahe_fused.clahe_reference(x, nbins=nbins)
    torch.cuda.synchronize()
    errs = (float((mapping_p - want_mapping).abs().max()),
            float((out - clahe_fused.remap_reference(x, mapping_p))
                  .abs().max()),
            float((out - want).abs().max()))
    print(f'clahe pair {shape} nbins {nbins}: histograms '
          f'{"equal" if torch.equal(hist_p, want_hist) else "DIFFER"}, '
          f'mapping max|d| = {errs[0]:.3g}, output max|d| = {errs[2]:.3g}',
          flush=True)
    check(bool(torch.equal(hist_p, want_hist)),
          f'clahe_hist_lut histograms differ at {shape}')
    check(max(errs) <= 2e-5, f'clahe pair disagrees with twins at {shape}')
    return x, mapping_p, errs

  x_small, small_err = hold_small((256, 128, 128), 256)
  hold_small((64, 128, 128), 128)
  x8 = frames((8, 128, 128))
  s_out, s_hist = clahe_fused.clahe_small(x8, return_hist=True)
  p_hist, p_map = clahe_fused.clahe_hist_lut(x8)
  route_err = float((s_out - clahe_fused.clahe_remap(x8, p_map)).abs().max())
  print(f'clahe_small vs split pair (8, 128, 128): max|d| = {route_err:.3g}',
        flush=True)
  check(bool(torch.equal(s_hist, p_hist)) and route_err <= 2e-5,
        'clahe_small and the split pair differ')
  x_mid, map_mid, mid_errs = hold_pair((128, 256, 256), 256)
  hold_pair((64, 384, 384), 256)
  hold_pair((64, 128, 128), 128)

  nb, nh, nw = 128, 256, 256
  params_mid = imaging_params.sample_imaging_params(gen, nb, device=dev,
                                                    noisy=True)
  packed_mid = noise_fused.pack_params(params_mid, nb)
  draws_mid = noise_fused.sample_draws(gen, nb, nh, nw, dev)
  noise_mid_err = float((
      noise_fused.noise_chain(x_mid, packed_mid, draws=draws_mid)
      - noise_fused.noise_chain_reference(x_mid, packed_mid, draws=draws_mid)
  ).abs().max())
  print(f'noise_chain injected draws (128, 256, 256): max|d| = '
        f'{noise_mid_err:.3g}', flush=True)
  check(noise_mid_err <= 1e-5, 'noise_chain disagrees with its twin at 256^2')
  del draws_mid

  # Times: four buffers in turn (67 MB and 134 MB of frames, above the
  # 50 MB L2), and the same launch on one buffer for the L2-warm time.
  small_inputs = [x_small] + [frames((256, 128, 128)) for _ in range(3)]
  t_small = time_rotating_ms(clahe_fused.clahe_small, small_inputs)
  t_small_warm = time_ms(lambda: clahe_fused.clahe_small(x_small))
  t_small_plain = time_ms(lambda: clahe_fused.clahe_reference(x_small),
                          repeats=20)
  n_small = x_small.numel()
  rows['clahe_small'] = (
      t_small, t_small_plain, small_err,
      *bound(8.0 * n_small,
             (HIST_OPS_PER_PIXEL + REMAP_OPS_PER_PIXEL) * n_small),
      SOURCES['clahe_small'])
  shapes = {'noise_chain': (b, h, w), 'clahe_hist_lut': (b, h, w),
            'clahe_remap': (b, h, w), 'clahe_small': (256, 128, 128)}

  def pair(x):
    return clahe_fused.clahe_remap(x, clahe_fused.clahe_hist_lut(x)[1])

  t_pair_at_small = time_rotating_ms(pair, small_inputs)
  print(f'clahe_small (256, 128, 128): {t_small:.4f} ms ({t_small_warm:.4f} '
        f'ms on one L2-resident buffer); split pair at the same shape '
        f'{t_pair_at_small:.4f} ms', flush=True)
  del small_inputs

  mid_inputs = [x_mid] + [frames((128, 256, 256)) for _ in range(3)]
  n_mid = x_mid.numel()
  t_hist_mid = time_rotating_ms(clahe_fused.clahe_hist_lut, mid_inputs)
  t_remap_mid = time_rotating_ms(
      lambda x: clahe_fused.clahe_remap(x, map_mid), mid_inputs)
  t_pair_mid = time_rotating_ms(pair, mid_inputs)
  for name, ms, plain_fn, err, (bound_ms, bound_by) in [
      ('clahe_hist_lut', t_hist_mid,
       lambda: clahe_fused.hist_lut_reference(x_mid), mid_errs[0],
       bound(4.0 * n_mid + map_mid.numel() * 8, HIST_OPS_PER_PIXEL * n_mid)),
      ('clahe_remap', t_remap_mid,
       lambda: clahe_fused.remap_reference(x_mid, map_mid), mid_errs[1],
       bound(8.0 * n_mid + map_mid.numel() * 4,
             REMAP_OPS_PER_PIXEL * n_mid)),
  ]:
    other_shapes[name].append({
        'shape': [128, 256, 256], 'ms': ms,
        'plain_ms': time_ms(plain_fn, repeats=20), 'bound_ms': bound_ms,
        'bound_by': bound_by, 'max_abs_err': err})
  pair_bound, _ = bound(8.0 * n_mid, 0)
  print(f'clahe pair (128, 256, 256): hist_lut {t_hist_mid:.4f} + remap '
        f'{t_remap_mid:.4f} ms, both in turn {t_pair_mid:.4f} ms (bound of '
        f'the whole, frame read once and written once: {pair_bound:.4f} ms)',
        flush=True)
  del mid_inputs, x_mid, map_mid, x_small
  torch.cuda.empty_cache()

  # -- 9. path A: scene generator + shipped detector --------------------------
  from putting_dune_torch import lattice as lattice_lib
  from putting_dune_torch.agents import vision_planner
  from putting_dune_torch.atom_detection import data as det_data

  lat = lattice_lib.make_lattice(50, dev)
  batches = {}
  for size, on_route, off_route in [
      (128, ('clahe_small',), ('clahe_hist_lut', 'clahe_remap')),
      (256, ('clahe_hist_lut', 'clahe_remap'), ('clahe_small',))]:
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = det_data.sample_batch(gen, lat, batch_size=64, image_size=size,
                                  noisy=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = dict(_build.LAUNCHES)
    path_launches[f'generator_{size}'] = counted
    image, mask = batch['image'], batch['mask']
    print(f'path A sample_batch 64 x {size}^2 noisy: {seconds * 1e3:.1f} ms, '
          f'launches {counted}', flush=True)
    check(tuple(image.shape) == (64, size, size, 1)
          and tuple(mask.shape) == (64, size, size, 3), 'sample_batch shapes')
    check(bool(torch.isfinite(image).all()) and float(image.min()) >= 0.0
          and float(image.max()) <= 1.0 + 1e-6, 'sample_batch image range')
    check(bool((mask.sum(-1) == 1).all())
          and bool(((mask == 0) | (mask == 1)).all()), 'masks are not one-hot')
    check(bool((mask[:, size // 2, size // 2, 2] == 1).all()),
          'the silicon is not labelled at the centre')
    for name in ('noise_chain',) + on_route:
      check(counted[name] > 0, f'{name} was not launched by sample_batch '
            f'at {size}^2')
    for name in off_route:
      check(counted[name] == 0, f'{name} launched at {size}^2: wrong route')
    batches[size] = batch

  t0 = time.perf_counter()
  detector = vision_planner.load_shipped_detector(device=dev,
                                                  allow_tf32=False)
  detector_tf32 = vision_planner.load_shipped_detector(device=dev)
  print(f'shipped detector loaded twice in {time.perf_counter() - t0:.2f} s',
        flush=True)
  clean_256 = det_data.sample_batch(gen, lat, batch_size=64, image_size=256,
                                    noisy=False)
  for label, batch in (('noisy', batches[256]), ('clean', clean_256)):
    logits = detector(batch['image'])
    check(tuple(logits.shape) == (64, 256, 256, 3)
          and bool(torch.isfinite(logits).all()), 'detector logits')
    truth = batch['mask'].argmax(-1)
    acc = float((logits.argmax(-1) == truth).float().mean())
    logits_tf32 = detector_tf32(batch['image'])
    acc_tf32 = float((logits_tf32.argmax(-1) == truth).float().mean())
    agree = float((logits_tf32.argmax(-1) == logits.argmax(-1))
                  .float().mean())
    print(f'path A detector on 64 x 256^2 {label}: pixel accuracy {acc:.4f} '
          f'(bar {DETECTOR_ACCURACY_BARS[label]}); with TF32 convolutions '
          f'{acc_tf32:.4f}, argmax agreement {agree:.5f}, logits max|d| '
          f'{float((logits_tf32 - logits).abs().max()):.3g}', flush=True)
    check(min(acc, acc_tf32) >= DETECTOR_ACCURACY_BARS[label],
          f'detector accuracy on {label} scenes below the bar')
    del logits, logits_tf32
  frames_100 = torch.cat([batches[256]['image'], clean_256['image']])[:100]
  unet = {}
  for label, fn in (('f32', detector), ('tf32', detector_tf32)):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    unet[label] = (time_ms(lambda: fn(frames_100), repeats=5, warmup=2),
                   torch.cuda.max_memory_allocated() / 2**30)
  print(f"UNet forward (100, 256, 256, 1): {unet['tf32'][0]:.2f} ms with "
        f"TF32 convolutions (the default; peak memory {unet['tf32'][1]:.2f} "
        f"GiB), {unet['f32'][0]:.2f} ms in full f32 "
        f"({unet['f32'][1]:.2f} GiB)", flush=True)
  del batches, clean_256, frames_100, detector, detector_tf32
  torch.cuda.empty_cache()

  # -- 10. path B: vision planner and planner on small_eval -------------------
  def run_eval(name, bar):
    _build.reset_launches()
    torch.cuda.synchronize()
    rep = eval_cli.main(eval_cli.Args(
        experiment_name=name, eval_suite='small_eval', device='cuda'))
    torch.cuda.synchronize()
    counted = dict(_build.LAUNCHES)
    a = rep['aggregate']
    print(f"path B {name} small_eval: success "
          f"{a['average_num_times_reached_goal']}, average actions "
          f"{a['average_num_actions_taken']:.2f}, {rep['env_steps']} env "
          f"steps in {rep['wall_seconds']:.2f} s = "
          f"{rep['env_steps'] / rep['wall_seconds']:.1f} env steps/s, "
          f"launches {counted}", flush=True)
    check(a['average_num_times_reached_goal'] >= bar,
          f'{name} success below {bar}')
    return counted

  counted = run_eval('vision_planner_simple_rates', 0.90)
  path_launches['vision_planner_512'] = counted
  for name in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
    check(counted[name] > 0, f'{name} was not launched on path B')
  run_eval('planner_simple_rates', 0.95)

  # -- 11. kernels line --------------------------------------------------------
  kernels = []
  for name, (ms, plain_ms, err, bound_ms, bound_by, source) in rows.items():
    by_path = {path: counts[name] for path, counts in path_launches.items()}
    total = sum(by_path.values())
    check(total > 0, f'{name} was launched on no main path')
    print(f'{name}: {ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}), '
          f'plain twin {plain_ms:.4f} ms, launches {by_path}, at '
          f'{shapes[name]} on {smi}', flush=True)
    for extra in other_shapes[name]:
      print(f"{name}: {extra['ms']:.4f} ms (bound {extra['bound_ms']:.4f} "
            f"ms, {extra['bound_by']}), plain twin {extra['plain_ms']:.4f} "
            f"ms, at {tuple(extra['shape'])} on {smi}", flush=True)
    kernels.append({
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': TPU_SITES[name], 'launches': total,
        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
        'shape': list(shapes[name]), 'launches_by_path': by_path,
        'other_shapes': other_shapes[name],
    })
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  main()
