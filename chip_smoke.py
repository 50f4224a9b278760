"""End-to-end check of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card name and power limit; CUDA must be available;
  2. build every CUDA kernel of the main path from csrc/ (nvcc, parallel);
  3. noise_chain against its plain twin at (100, 512, 512): injected draws
     element-wise (max |d| <= 1e-5); in-kernel Philox draws element-wise
     against the twin fed `draws_from_seeds` (at most 1e-5 of the pixels may
     differ; 0 is what the card gives) and in distribution;
  4. clahe_hist_lut + clahe_remap against their twins at (100, 512, 512),
     grid 8: histograms equal, max |d| <= 2e-5; the mapping bit-equal (max
     |d| 0) to `hist_lut_order_exact`, the sums in the kernel's order;
  5. each kernel timed (CUDA events around one call, median of 30 launches:
     the wrapper's host time included) beside its twin and its bound;
     every kernel also by its device time alone (CUPTI, `torch.profiler`,
     the mean launch over a window of 20 calls whose every launch was
     recorded, of up to three; else "not measured"), here and at the other
     shapes of phases 8, 11 and 12;
  6. the main path: `ppo_simple_images_tf` on small_eval (100 seeds, 512^2
     render) through the port's eval entry point on CUDA; success >= 0.95,
     average actions within 30.09 +- 6 (the JAX package's eval.json), every
     kernel launched;
  7. `greedy_simple_rates` on tiny_eval reaches the goal every time;
  8. the other CLAHE routes: `clahe_small` against `clahe_reference` at
     (256, 128, 128) and at (64, 128, 128) with 128 bins, and against the
     split pair at (8, 128, 128) (max |d| 0); the pair against its twins at
     (128, 256, 256), (64, 384, 384) and (64, 128, 128) with 128 bins
     (histograms equal, max |d| <= 2e-5; mappings max |d| 0 against
     `hist_lut_order_exact`), at (16, 240, 360) on a 6 x 6 grid, at
     (4, 264, 328) (tiles 33 x 41 pixels), at (8, 256, 256) with 100 bins
     and at (2, 256, 256) on a 4 x 4 grid with 1024 bins; noise_chain with
     injected draws at (128, 256, 256) and at (3, 200, 328), whose rows do
     not divide over the blocks of a frame, and
     with Philox draws element-wise at (128, 256, 256); `clahe_small`, the
     pair and noise_chain at (100, 256, 256) timed with bounds;
  9. path A, generator + detector: `sample_batch` at batch 64, noisy, at
     128^2 (must launch `clahe_small`) and 256^2 (must launch the pair),
     each timed warm, after one call of its own;
     shapes, ranges, one-hot masks; the shipped UNet's pixel accuracy on
     the 256^2 batches (noisy and clean) against `DETECTOR_ACCURACY_BARS`;
     the UNet forward timed at (100, 256, 256, 1), TF32 (the detector's
     default on the card) and full f32;
  10. path B: `vision_planner_simple_rates` on small_eval (512^2 render ->
      256^2 features -> UNet -> lattice frame -> planner), success >= 0.90;
      `planner_simple_rates` on small_eval, success >= 0.95;
  11. `splat_render` against its twin and against the default route
      (`_splat_axis_kernels` + `torch.bmm`) on the atom windows of a
      `multi_dopant_3_vision_planner` env at batch 100, at S = 256 and 512
      (max |d| <= 1e-5) and bit-equal (max |d| 0) to
      `splat_render_atom_order`, also at (1, 77, 200) and with a radius
      above a block's band of rows; timed beside both and its bound;
  12. `clahe_interp` against its twin on the dual blocks of that env's
      noisy frames at (100, 81, 1024) and (100, 81, 4096) with 256 bins and
      at 128 bins (max |d| <= 1e-6); `equalize_adapthist(backend='interp')`
      against the default route at (100, 256, 256) and (100, 512, 512)
      (max |d| <= 2e-5); timed beside `clahe_remap` on the same frames;
  13. path C: the env's atom windows -> fused splat -> noise_chain ->
      interpolation route -> shipped UNet -> multi-dopant vision policy; the
      actions are finite, in [-1, 1], and within 0.05 of the actions from
      the default CLAHE route on the same noisy frames for >= 99 of 100 envs;
  14. path A: `multi_dopant_3_planner` on small_eval, success >= 0.95;
      `multi_dopant_2_distilled` on tiny_eval, success >= 0.75;
  15. path B: `multi_dopant_3_vision_planner` on small_eval (batch 100,
      256^2 frames, UNet, peaks, planner), success >= 0.85 (the JAX
      package's rate less three standard errors), the noise chain and the
      split CLAHE pair launched;
  16. instrument drift (0.5 A per frame per axis), each on small_eval
      through the eval entry point: `planner_simple_drift` and
      `ppo_simple_drift` (success >= 0.5, the JAX test's bar);
      `vision_planner_drift` and `vision_planner_drift_corrected` (512^2
      render -> 256^2 features; `noise_chain`, `clahe_hist_lut` and
      `clahe_remap` launched); `multi_dopant_2_vision_planner_drift` and
      its `_corrected` twin (256^2 frames; `noise_chain` and the split pair
      launched). Each corrected entry reaches `DRIFT_SUCCESS_BARS` (the JAX
      package's CPU success less three binomial standard errors), and the
      multi-dopant corrected entry succeeds more often than its twin;
  17. the rate stack: the shipped rate predictor on CUDA against the same
      function on the CPU at the planner's 64,000 rows (max |d| <= 1e-5)
      and correlated above 0.95 with `prior_rates_aligned` (the JAX test's
      bar); the fifteen runnable entries of the rate stack, each on small_eval
      through the eval entry point, at or above `RATE_STACK_BARS` (the JAX
      package's CPU success less three binomial standard errors, where that
      is above 0.1), the two vision entries launching `noise_chain`,
      `clahe_hist_lut` and `clahe_remap`, and
      `planner_distilled_prior_variable_time` raising FileNotFoundError;
      the trainer at the shipped widths (50 models, hidden (128, 128), batch
      256, batch norm, augmentation, bootstrap) for 3 epochs on 40,960
      synthetic prior transitions made on the card, its loss on the data
      below the loss at initialisation for every model; distillation at
      batch 4096 (20 epochs of 10 batches); a save -> load round trip equal
      on the card; the 2-model argmax-recovery probe (>= 2 of 3);
  18. training, at the shipped configurations' widths (only the number of
      updates cut): (a) vector PPO on `ppo_learned_2s` (batch 1024, rollout
      64, 4 x 8 minibatches, hidden (256, 256)) from `PPO_VECTOR_SEED` for
      `PPO_VECTOR_UPDATES` updates through `train_and_save` in two chunks
      with a rolling
      checkpoint; the loss finite, the terminal rate over updates 40-49 at
      least twice that over 0-9 and at least `PPO_TERMINAL_RATE_BAR`; the
      saved policy loaded and on small_eval at least `PPO_SUCCESS_BAR`;
      (b) pixel PPO on `relative_simple_rates_from_images` (batch 256, 128^2
      render, rollout 16, shaping 0.05) for 10 updates: `noise_chain` and
      `clahe_small` launched once a rollout step and once for the reset,
      the loss finite, the parameters moved; save -> load -> mean actions
      in [-1, 1], a warm start holding the checkpoint exactly; 2 updates at
      the 512^2 render launching `noise_chain`, `clahe_hist_lut` and
      `clahe_remap` once a step and reset; (c) multi-dopant PPO (batch 1024,
      2 dopants, dwell 5 s, rollout 64, shaping 0.05) for 5 updates, finite;
      (d) DAgger as `planner_distilled_prior` was made (batch 1024, 12
      iterations of 64 steps and 384 SGD steps of 4096): the student on
      small_eval through the repo's ship gate (success >= 0.95, actions <=
      1.5x the live `planner_prior_rates` of phase 17), save -> load acting
      the same; each timed (seconds, env steps/s, gradient steps/s);
  19. the hardware loop (the real-microscope path at batch 1): (a) the
      shipped ImageAligner (features (64, 128, 256, 512), 5 frames, 128^2;
      full-f32 convolutions) on the card against the port on the CPU over
      a 12-frame drifting sequence: drift heads within 1e-4 A, queried
      probabilities, and the whole local head and drifts of one stack,
      within 1e-3, detections equal sets, `clahe_small` once a frame; one 1000 x 1000 frame, whose 1008^2 padded CLAHE takes
      `clahe_hist_lut` + `clahe_remap` once each and agrees with its twin
      within 2e-5; (b) `do_alignment` on `ALIGNMENT_SEEDS` sequences at 0.5 A
      a frame, by the aligner on the card and by the port on the CPU: the
      recovered FOVs agree within `ALIGNMENT_FOV_TOL`, and they recover the
      simulator's drift: mean increment error < 0.35 A (the JAX test's bar)
      and mean last-three-frames error within the JAX package's (its test's
      other bar, 0.8x uncorrected, holds on 0.29 of the JAX package's own
      sequences: see ALIGNMENT_SEEDS);
      (c) the rehearsal, `SimulatedMicroscope` -> `ImageAligner` ->
      `MicroscopeAgent('greedy_on_neighbor')`, 35 steps from each of
      `REHEARSAL_SEEDS` seeds, corrected and uncorrected: the corrected
      loop brings the true silicon within 0.72 A of the goal on at least
      `REHEARSAL_REACH_BAR` of the seeds, `clahe_small` launched once a
      render and once an aligner frame; (d) `AtomDetector` on the card
      against the port on the CPU on `DETECTOR_FRAMES` clean generator
      scenes at 256^2: equal sets on >= 0.99 of them, recall printed;
      (e) each of the 16 microscope experiments drives the simulated
      microscope for 5 steps with controls in [0, 1]^2, or raises where the
      JAX package raises (`ppo_simple_images_tf`); (f) the host eval entry
      point (`--nobatched`): `greedy_simple_rates` 10 of 10 on tiny_eval,
      `ppo_simple_images_tf` at the 512^2 render >= 9 of 10, `noise_chain`
      and the natural pair once a render, `--output_json` read back; (g)
      each kernel of the loop against its plain twin on inputs the loop gave
      it, at the loop's shapes: `noise_chain` on a clean (1, 128, 128) render
      of the microscope and a clean (1, 512, 512) render of the pixel host
      eval (injected draws within 1e-5; Philox draws against the twin fed
      `draws_from_seeds`), `clahe_small` on a (1, 128, 128) render and on an
      aligner frame, the pair on a (1, 512, 512) render (histograms equal,
      output within 2e-5 of `clahe_reference`); every timing printed with
      the card's name and power limit;
  20. perception training at the shipped widths (only steps cut): (a) the
      shipped detector's noise-robust fine-tune (features (64, ..., 1024),
      256^2, batch 32, noisy_fraction 0.4, class weights (0.2, 1, 10), lr
      1e-4, seed 13; 2 epochs x 8 steps, 4 eval steps): the fine-tuned
      pixel accuracy on fixed noisy batches at least
      `DETECTOR_FINETUNE_BAR` (the shipped model's printed beside it), the
      kept best checkpoint the one `best_fn` picks and `load_params`'s,
      `save_params_msgpack` -> `AtomDetector` giving the trained logits
      bit for bit; (b) the shipped aligner's registration fine-tune
      (features (64, ..., 512), 128^2, 5 frames, batch 32,
      registration_noise 0.35, inference preprocessing, seed_fraction
      0.25; 8 steps, 4 eval steps): the drift error on fixed stacks before
      and after, after at most `ALIGNER_FINETUNE_BAR`, save -> reload bit
      for bit; (c) the shipped graph aligner below the zero predictor's
      drift error on fixed batches, and a fresh trainer (the Config
      defaults, 3 x 20 steps) below `GRAPH_TRAIN_BAR`; (d) the train CLI
      and `save_model` in subprocesses; for each trainer, one train step
      of the trained state with every parameter held to AdamW's update
      computed in float64 from the optimizer's moments and the card's
      gradients (within 1e-3 lr plus float32 rounding), then its train
      step timed (CUDA events, the data step apart; the detector's also
      with TF32),
      its busy share and device operations a step; the trainers' kernel
      launches under `perception_training`; (e) `noise_chain`, the pair
      and `clahe_small` against their twins on the frames the trainers
      gave them, at (32, 256, 256) and (32, 128, 128);
  21. the data pipeline on record files, at a few microscope sessions'
      size: (a) `PIPELINE_EPISODES` episodes of the phase 19c rehearsal
      (no aligner) recorded by `MicroscopeAgentLogger` (128^2 frames), the
      logger's TFRecord file equal to the trajectories' bytes, decoded
      trajectories equal to the recorded ones, written and read back as
      TFRecord and as riegeli with every codec the machine has (payloads
      equal); (b) the `align_trajectories` CLI in a subprocess on the
      logger's file: the first `PIPELINE_ALIGNED` of its trajectories
      within `ALIGNMENT_FOV_TOL` of `do_alignment` in memory; (c)
      `trajectories_to_transitions` and `train_rate_learner` on the aligned
      file, at the shipped widths (only the epochs cut, see
      PIPELINE_RATE_EPOCHS): drop reasons, the first and last epoch's loss,
      the saved predictor as a learned-rate planner's rate function finite
      and positive; (d) the
      detector's record dataset (256^2 noisy, 2 shards of 64) and 4 train
      steps from `records:<dir>` at the shipped widths, a train and a data
      step timed beside phase 20's; `noise_chain`, `clahe_small` and the
      pair launched; (e) TFRecord and riegeli MB/s and the wire codec's us
      an observation, on the host, the atomic grids' also through the
      codec's object per atom; (f) `noise_chain`, `clahe_small` and the
      pair against their twins on the frames the pipeline gave them;
  22. plots, videos and the mesh at world 1: (a) `ppo_simple_images_tf`
      (512^2 render) on VIDEO_SEEDS seeds with VIDEO_ENVS episode videos:
      results equal to the same seeds without videos, each GIF `steps + 1`
      frames with frame 0 bit-equal to the raster frame rebuilt from a
      reset on the evaluator's stream, ms a frame to rasterise and to
      encode, MB written; the host evaluator writes seed 0's GIF; (b)
      `DmEnvWrapper.render()` (500, 500, 3) uint8, not blank; (c) the
      rate-learner CLI in a subprocess on phase 21's aligned file with its
      plot flags (21c's epochs, --nodistill): every `{k}.png` and
      `avg_context_rates.png` decodes through io/png.py; (d) `nccl` at
      world 1 over a localhost TCP store: `train_ppo --mesh=data:1` at 18b's
      128^2 pixel config for MESH_PPO_UPDATES updates equal to the
      unsharded run within 1e-6 (`noise_chain` and `clahe_small` once a
      step), `eval --mesh=data:1` per seed equal to the unsharded run, the
      rate learner's model axis equal to the plain ensemble, the PPO dry
      run, one update timed with and without the process group, and
      `--mesh=data:2` refused on one card; (e) `noise_chain`, the pair and
      `clahe_small` against their twins on the frames (a) and (d) gave
      them;
  23. the classical rate learners and JPEG (no kernel of its own): (a)
      the rate-learner CLI once for each of the five classical types
      (sklearn_mlp, knn, gp, random_forest, svm), five subprocesses at
      once on phase 21's aligned file at the CLI's defaults with only
      --num_models cut (CLASSICAL_MODELS): seconds each and the seconds
      of it spent writing sklearn's `.joblib` files, mean train / test
      accuracy against CLASSICAL_BARS, the fitted tensors on `cuda`, the
      files written, and those files read back by the port's reader on
      the card: max|d| of predict_proba against the fitted models; (b) the committed JAX-package `.joblib` fixtures
      (tests/data/torch_classifiers) read by the port, `predict_proba` on
      the card within 1e-9 of sklearn's recorded arrays; (c) the committed
      JPEGs (tests/data/torch_jpeg) decoded on the host with max |d| 0
      against cv2's recorded pixels, MB/s, and a TFDS shard of them
      through the import CLI;
  24. TF SavedModel interop and the authenticated GCS download (no kernel
      of its own): (a) the shipped detector (64..1024, 256^2), aligner
      (64..512, 128^2 x 5), rate predictor and `230422_ppo_v3_2s` MLP
      exported through the port (`io/tf_export.py`), reloaded on the card
      and held against their native forwards in full float32: export and
      load seconds, MB, the interpreter's forward ms beside the native ms,
      max|d|; (b) SAVED_MODEL_SCENES noisy 256^2 scenes (`noise_chain` +
      the CLAHE pair) through the loaded detector and a 128^2 x 5 stack of
      `clahe_small` aligner frames through the loaded aligner, with their
      launches counted, and those kernels held against their twins at
      these shapes; (c) the committed JAX-made SavedModels
      (tests/data/torch_saved_models) against JAX's recorded outputs;
      (d) one episode of the host evaluator on `eval_ppo_v3_2s` through
      `TfSavedModelAgent` on the exported policy, each action held to
      EvalAgent's; (e) the authenticated download (`io/gcs.py`) against a
      loopback token endpoint and media server in the process, with a
      throwaway RSA key: ms to sign, for the grant and for the download;
  25. the last gaps to the JAX package (no kernel of its own): (a) every
      name the JAX package's subpackages re-export, and
      `experiments.registry`, imported from the port (the classical CLI's
      sklearn files are 23a's); (b) the four shipped models exported
      `with_gradient=True` at full width and batch 1, reloaded on the
      card, their gradient by autograd through the loader held against
      native autograd in full float32: export seconds, MB, max|d|;
  26. API parity, the keywords the JAX package takes: (a)
      `ppo_simple_images_tf` through `create_batched_env` (batch 100,
      512^2 render, small_eval) by `evaluate_batched` with `chunk_steps=1`
      and with the default 64: identical results, success >= 0.95, env
      steps/s of each and the launches of `noise_chain`, `clahe_hist_lut`
      and `clahe_remap` printed; (b) the same with `max_steps=100`: every
      episode that ended within 100 steps as in (a), every other one not
      reached at 100 steps, the JAX evaluator's count; (c)
      `greedy_simple_rates` on `create_batched_env(grid_columns=30)` at
      batch 1000 (medium_eval): its lattice is `make_lattice(30)`, success
      and actions to the JAX package's (GREEDY_GRID30_BAR,
      GREEDY_GRID30_ACTIONS); (d) the shipped
      `ppo_simple_images_tf` agent `.save`d and loaded back, and rebuilt
      by `EvalAgent.from_actor_critic(agent.params, ...)`: both act with
      max|d| 0 against the shipped agent on 100 frames of the env; (e)
      `noise_chain` and the CLAHE pair held against their twins on the
      frames (a) gave them;
  27. SavedModels of TF ops, as jax2tf's pre-native path wrote the
      reference's 2023 policies (no kernel of their own beyond 27c's): (a)
      every committed fixture (tests/data/torch_tf_graphs: five models in
      the `xla` and `plain` modes) loaded on the card against TF's
      recorded outputs (TF_GRAPH_TOLERANCES): load and first-call seconds,
      forward ms, max|d|; (b) one episode of the host evaluator on
      `eval_ppo_v3_2s` through `TfSavedModelAgent` on the full-width
      `ppo_v3_2s_xla` graph, each action held to EvalAgent's on the
      shipped checkpoint (bar 1e-5); (c) a tiny_eval host pixel eval at the
      128^2 render through the narrow actor-critic graphs of both modes on
      the env's dict observation (episodes cut at TF_GRAPH_PIXEL_STEPS):
      `noise_chain` and `clahe_small` launched once a render; (d) those two
      kernels held against their twins on the frames (c) gave them;
  28. a `kernels` JSON line; 29. the result JSON line, last.

It imports nothing of JAX or of putting_dune_tpu (the shipped weights are
read as data).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and f32
# throughput outside the tensor cores. The data sheet gives no int32 rate:
# an SM has 64 int32 lanes beside its 128 f32 lanes, so half the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12

# The least a noise chain with in-kernel draws does per pixel, from
# csrc/noise_chain.cu, every transcendental and every divide as one
# operation. int32: two Philox4x32-10 blocks of 10 rounds of two 32 x 32 ->
# 64 multiplies (4 words) and 4 xors, and one shift for each of the six
# uniforms. f32, whatever the pixel: six uniforms (convert, mul, add) 18; the
# Box-Muller pair (max, log, mul, sqrt, mul, sin, cos, 2 mul) 9; lambda, its
# clamp and its compare 3; three renorms (divide, running max, clamp) 9; salt
# & pepper 5; gamma (compare, max, log, mul, exp, select) 6; uniform 2;
# exponential (max, log, neg, mul, add) 5; Gaussian and clip 4. The Poisson
# count adds 62 below lambda = 4 (neg, exp, 12 x (compare, add, 2 mul, add))
# and 6 above (sqrt, mul, 2 add, floor, max): the bound counts this run's
# pixels on each side.
NOISE_INT_OPS_PER_PIXEL = 2 * 10 * 8 + 6
NOISE_F32_OPS_PER_PIXEL = 18 + 9 + 3 + 9 + 5 + 6 + 2 + 5 + 4
NOISE_POISSON_OPS = {'small': 62, 'large': 6}
# clahe_hist_lut: scale, cast, clamp, shared atomic add per pixel.
HIST_OPS_PER_PIXEL = 4
# clahe_remap: bin (3), indices and weights (~12), 4 mul + 3 add.
REMAP_OPS_PER_PIXEL = 22
# clahe_interp: clamp (2), 4 mul + 3 add.
INTERP_OPS_PER_PIXEL = 9

# Least pixel accuracy of the shipped detector's argmax against the label
# mask on the port's own 256^2 scenes: the JAX package's value on its own
# scenes less 0.02 (0.825 noisy, 0.951 clean; tests/test_torch_detector.py
# measures both packages and holds these bars to that rule).
DETECTOR_ACCURACY_BARS = {'noisy': 0.80, 'clean': 0.93}

# Least success of `multi_dopant_3_vision_planner` on small_eval: the JAX
# package's 0.93 on the same 100 seeds on the CPU
# (`scripts/eval_cpu_pair.py --seeds=small_eval`; the port there reads
# 0.95) less three binomial standard errors at 100 episodes (3 x 0.0255).
MULTI_DOPANT_VISION_SUCCESS_BAR = 0.85

# Least success of the drift-corrected entries on small_eval: the JAX
# package's success on the same 100 seeds on the CPU
# (`scripts/eval_cpu_pair.py --seeds=small_eval`) less three binomial
# standard errors at 100 episodes.
DRIFT_SUCCESS_BARS = {
    'vision_planner_drift_corrected': 0.99 - 3 * 0.00995,
    'multi_dopant_2_vision_planner_drift_corrected': 0.92 - 3 * 0.0271,
}

# The JAX package's success on small_eval of each entry the rate stack adds,
# both packages on the CPU on the same 100 seeds
# (`scripts/eval_cpu_pair.py --seeds=small_eval`).
RATE_STACK_JAX_SUCCESS = {
    'relative_random_prior_rates': 0.05,
    'planner_prior_rates': 1.0,
    'greedy_prior_rates': 0.01,
    'planner_learned_rates': 1.0,
    'planner_prior_rates_variable_time': 1.0,
    'planner_distilled_prior': 0.99,
    'greedy_aligned_prior_rates': 1.0,
    'vision_planner_prior_rates': 1.0,
    'vision_planner_learned_rates': 0.99,
    'eval_ppo_learned_tf_2s': 1.0,
    'eval_ppo_learned_tf_3s': 1.0,
    'eval_ppo_learned_tf_4s': 1.0,
    'eval_ppo_v3_2s': 0.99,
    'eval_ppo_v3_3s': 1.0,
    'eval_ppo_v3_4s': 1.0,
}


def success_bar(p: float, n: int = 100):
  """p less three binomial standard errors at n episodes, or None where
  that is not above 0.1. At p = 0 or 1, where the plug-in error
  sqrt(p (1 - p) / n) is 0, the Agresti-Coull one (p~ = (x + 2) / (n + 4)
  over n + 4 trials)."""
  if 0.0 < p < 1.0:
    se = (p * (1.0 - p) / n) ** 0.5
  else:
    q = (p * n + 2.0) / (n + 4.0)
    se = (q * (1.0 - q) / (n + 4.0)) ** 0.5
  bar = p - 3.0 * se
  return bar if bar > 0.1 else None


RATE_STACK_BARS = {name: success_bar(p)
                   for name, p in RATE_STACK_JAX_SUCCESS.items()}

# Phase 18a trains `ppo_learned_2s` at the shipped widths for 50 of the
# shipped run's 400 updates. Within 50 updates PPO at this config takes off
# (terminal rate over updates 40-49 above 0.005) from 8 of 12 seeds in the
# JAX package on the CPU and from 3 of 6 in the port on the card
# (`scripts/train_seeds.py --package=jax|torch`, seeds 0-11 and 0-5); the
# others stay below 2e-4. The smoke trains from seed 3, the first seed of
# the port's census that took off (seed 0 did not).
PPO_VECTOR_UPDATES = 50
PPO_VECTOR_SEED = 3
# The eight JAX runs that took off read a 40-49 terminal rate of 0.02411
# (standard deviation 0.00515 over seeds; the shipped run, seed 0 on a TPU,
# 0.0304 in runs/ppo_learned_2s/train_metrics.npz) and a small_eval success
# of 0.8325. Bars: that rate less three standard deviations, and that
# success less three binomial standard errors at 100 episodes.
PPO_TERMINAL_RATE_BAR = 0.02411 - 3 * 0.00515
PPO_SUCCESS_BAR = success_bar(0.8325)

# Phase 19c rehearses the hardware loop (`greedy_on_neighbor`, 0.5 A per
# frame, 128^2 renders, 35 steps) from seeds 0 .. REHEARSAL_SEEDS - 1. The
# JAX package brings the true silicon within 0.72 A of the goal, with the
# aligner in the loop, on REHEARSAL_JAX_REACH of seeds 0-69 on the CPU
# (`scripts/rehearsal_pair.py`); the port on the CPU reads
# REHEARSAL_PORT_REACH. A seed draws other episodes on the card (Philox on
# CUDA, threefry in JAX), so the bar is the JAX rate less three binomial
# standard errors at the smoke's number of seeds. Mean final distances
# (corrected, uncorrected), JAX on the CPU: REHEARSAL_JAX_FINAL.
REHEARSAL_SEEDS = 20
REHEARSAL_STEPS = 35
REHEARSAL_JAX_REACH = 59 / 70
REHEARSAL_PORT_REACH = 54 / 70
REHEARSAL_JAX_FINAL = (3.745, 2.486)
REHEARSAL_REACH_BAR = REHEARSAL_JAX_REACH - 3 * (
    REHEARSAL_JAX_REACH * (1 - REHEARSAL_JAX_REACH) / REHEARSAL_SEEDS) ** 0.5
# Phase 19b: do_alignment over 12-frame sequences drifting 0.5 A a frame
# (the JAX package's test_learned_aligner_recovers_simulated_drift), from
# seeds 0-7, the first of the census below. The aligner on the card and the
# port on the CPU align each sequence: their recovered FOVs must agree
# within ALIGNMENT_FOV_TOL A, which checks the aligner itself
# (tests/test_torch_image_alignment.py holds the port's do_alignment on the
# CPU to the JAX package's within 1e-4). The JAX test's bars on one
# sequence are an increment error below 0.35 A and a last-three-frames
# error below 0.8x the uncorrected one. Over seeds 0-23 on the CPU
# (`scripts/rehearsal_pair.py --alignment`) the JAX package meets the first
# on 0.96 of the sequences (mean 0.2590 A, sd 0.0370) and the second on
# 0.29 only: its mean last-three error, 1.1970 A (sd 0.5601), is above the
# uncorrected 1.1106 (the port: 0.2492 A, 1.0 of them; 1.1587 against
# 1.0146, 0.38). The smoke holds the mean increment error to 0.35 A and the
# mean last-three error to the JAX mean plus three standard errors at its
# number of sequences, a bar that the uncorrected error meets too, and
# prints the 0.8x share.
ALIGNMENT_SEEDS = tuple(range(8))
ALIGNMENT_FOV_TOL = 1e-4
ALIGNMENT_JAX_LAST3 = (1.1970, 0.5601)
ALIGNMENT_LAST3_BAR = ALIGNMENT_JAX_LAST3[0] + 3 * ALIGNMENT_JAX_LAST3[1] / (
    len(ALIGNMENT_SEEDS) ** 0.5)
# Phase 19d: generator scenes for the detector on the card against the CPU
# (>= 0.99 of them equal: all of them at 50).
DETECTOR_FRAMES = 50

# Phase 20 (perception training at the shipped widths) holds each trainer
# to bars from `scripts/perception_bars.py`: the same recipes on the CPU at
# batch 8, each package in its own process, scored on PERCEPTION_EVAL_BATCHES
# fixed batches from the seed PERCEPTION_EVAL_SEED. The detector's noisy
# pixel accuracy after the fine-tune read 0.8492 (JAX; shipped 0.8492) and
# 0.8501 (port; shipped 0.8485): the bar is the lower less 0.02, the margin
# of the generator bars above. The aligner's drift error after its
# fine-tune read 0.0703 A (JAX; shipped 0.0657) and 0.0736 A (port;
# shipped 0.0598): the fine-tune at lr 1e-3 on converged weights raises it
# by 0.005-0.014 A in 8 steps, so the bar is twice the higher reading,
# still a fifth of the zero predictor's error. The shipped graph aligner
# must beat the zero predictor (JAX 0.0385 against 0.3609 A, port 0.0728
# against 0.4027 A on their CPU batches).
PERCEPTION_EVAL_SEED = 1000
PERCEPTION_EVAL_BATCHES = 4
DETECTOR_FINETUNE_BAR = min(0.8492, 0.8501) - 0.02
ALIGNER_FINETUNE_BAR = 2 * max(0.0703, 0.0736)
# The JAX package's test of the graph trainer holds a small run below 2 A.
GRAPH_TRAIN_BAR = 2.0
ROOT = os.path.dirname(os.path.abspath(__file__))

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
    'splat_render': 'putting_dune_tpu/ops/splat_pallas.py:150',
    'clahe_interp': 'putting_dune_tpu/ops/clahe_pallas.py:78',
}

SOURCES = {name: f'putting_dune_torch/csrc/{name}.cu' for name in TPU_SITES}

# The `__global__` functions one wrapper call launches, once each, for the
# kernels timed by their device time alone. A profiler record names a
# template instantiation in full (`clahe_small_kernel<4, 8>(...)`): the
# names here are matched as parts of it.
KERNEL_NAMES = {
    'noise_chain': ('noise_chain_kernel',),
    'clahe_hist_lut': ('clahe_hist_lut_kernel',),
    'clahe_remap': ('clahe_remap_kernel',),
    'clahe_small': ('clahe_small_kernel',),
    'splat_render': ('splat_render_kernel',),
    'clahe_interp': ('clahe_interp_kernel',),
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


def rotating(fn, inputs):
  """A call of fn on each of `inputs` in turn."""
  state = {'i': 0}

  def call():
    fn(inputs[state['i'] % len(inputs)])
    state['i'] += 1

  return call


def time_rotating_ms(fn, inputs, repeats=30) -> float:
  """Median time of fn(x) over `inputs` in turn: buffers that together
  exceed the 50 MB L2, so each launch finds its frame in device memory."""
  return time_ms(rotating(fn, inputs), repeats=repeats, warmup=len(inputs))


def device_ms(fn, kernels, repeats=20, windows=3):
  """Device time of one call of fn, which launches each kernel named in
  `kernels` (part of its name) once: the sum of their mean durations, CUPTI
  through torch.profiler. The profiler may drop records, so a window of
  `repeats` calls counts only if it recorded every launch of every kernel;
  the first such of `windows` windows gives the reading, else None ("not
  measured")."""
  import torch
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile

  fn()
  torch.cuda.synchronize()
  for _ in range(windows):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(repeats):
        fn()
      torch.cuda.synchronize()
    ms = recorded_device_ms(prof.key_averages(), kernels, repeats)
    if ms is not None:
      return ms
  return None


def recorded_device_ms(events, kernels, repeats):
  """Sum over `kernels` of each one's mean device time in ms, from profiler
  averages (`key`, `count`, `device_time_total` in us); None where a kernel
  was not recorded exactly `repeats` times."""
  total_us = 0.0
  for name in kernels:
    hits = [e for e in events if name in e.key and e.device_time_total > 0]
    if sum(e.count for e in hits) != repeats:
      return None
    total_us += sum(e.device_time_total for e in hits) / repeats
  return total_us / 1e3


def busy_share(fn) -> tuple[float, float]:
  """(wall seconds, share of them the device ran kernels or copies) of one
  call of fn, under torch.profiler's CUDA tracing."""
  import torch
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile

  overhead = ('Command Buffer Full', 'Buffer Flush', 'Activity Buffer Request')
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.key not in overhead)
  return wall, busy_us / 1e6 / wall


def fmt_ms(ms) -> str:
  return 'not measured' if ms is None else f'{ms:.4f} ms'


def bound(nbytes: float, ops: float, int_ops: float = 0.0
          ) -> tuple[float, str]:
  """The larger of the bytes' time and the operations' time, in ms. f32 and
  int32 operations leave through the same dispatch ports, so their times add."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = (ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S) * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def noise_bound(clean, packed) -> dict:
  """Both bounds of noise_chain on these frames, and the larger."""
  npx = clean.numel()
  small = float((clean * packed[:, 0, None, None] < 4.0).float().mean())
  f32_ops = npx * (NOISE_F32_OPS_PER_PIXEL
                   + small * NOISE_POISSON_OPS['small']
                   + (1.0 - small) * NOISE_POISSON_OPS['large'])
  nbytes = 8.0 * npx + packed.numel() * 4 + packed.shape[0] * 8
  bound_ms, bound_by = bound(nbytes, f32_ops, NOISE_INT_OPS_PER_PIXEL * npx)
  return {'bound_ms': bound_ms, 'bound_by': bound_by,
          'bytes_bound_ms': bound(nbytes, 0)[0],
          'operations_bound_ms': bound(0, f32_ops,
                                       NOISE_INT_OPS_PER_PIXEL * npx)[0],
          'small_lambda_share': small}


def sass_summary(path: str, nvcc: str) -> list[str]:
  """Static instruction counts of each kernel in a built library, from
  `cuobjdump -sass` where the toolkit has it: total, integer multiplies,
  logic, f32 arithmetic, special-function and memory instructions."""
  import collections
  import re

  tool = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
  if not os.path.exists(tool):
    return ['cuobjdump not found']
  text = subprocess.run([tool, '-sass', path], capture_output=True, text=True,
                        timeout=120).stdout
  lines = []
  for body in re.split(r'\n\s*Function : ', text)[1:]:
    name = body.split('\n', 1)[0].strip()
    ops = collections.Counter(
        op.split('.')[0] for op in re.findall(
            r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)', body))
    groups = {
        'imad': ops['IMAD'], 'lop3': ops['LOP3'],
        'f32': sum(ops[k] for k in ('FFMA', 'FMUL', 'FADD', 'FMNMX', 'FSETP',
                                    'FSET', 'FSEL')),
        'mufu': ops['MUFU'],
        'memory': sum(ops[k] for k in ('LDG', 'STG', 'LDS', 'STS', 'LD',
                                       'ST')),
    }
    short = re.search(r'[a-z_]+_kernel(I\w{0,18})?', name)
    lines.append(f'{short.group(0) if short else name[-40:]}: '
                 f'{sum(ops.values())} instructions, {groups}')
  return lines


def rate_stack(dev, run_eval, eval_reports, path_launches) -> dict:
  """Phase 17 (see the module docstring); returns the numbers it read."""
  import dataclasses
  import math
  import tempfile

  import numpy as np
  import torch

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import rates as rates_lib
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.rate_learning import config as rl_config
  from putting_dune_torch.rate_learning import data_utils as rl_data
  from putting_dune_torch.rate_learning import losses as rl_losses
  from putting_dune_torch.rate_learning import predictor as rl_predictor

  out = {}
  # -- the shipped predictor, card against CPU, at the planner's rows --------
  shipped = os.path.join(eval_agent.MODEL_WEIGHTS_DIR, 'rate_predictor')
  preds = {}
  for key, device in (('card', dev), ('cpu', torch.device('cpu'))):
    preds[key] = rl_predictor.LearnedRatePredictor(
        config=rl_config.RateLearningConfig(beam_units='angstroms'),
        device=device)
    preds[key].load(shipped)
  gen = torch.Generator().manual_seed(7)
  n = 100 * 640  # batch 100 x the planner's 10 x 64 candidate beams
  si = torch.randn((n, 2), generator=gen) * 4.0
  angle = (torch.rand((n, 1), generator=gen) * 2.0 * math.pi
           + torch.tensor([0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0]))
  nbr = si[:, None, :] + 1.42 * torch.stack(
      [torch.cos(angle), torch.sin(angle)], dim=-1)
  beam = si + torch.rand((n, 2), generator=gen) * 3.6 - 1.8
  want = preds['cpu'].as_rate_function()(si, nbr, beam)
  rate_fn = preds['card'].as_rate_function()
  on_card = [t.to(dev) for t in (si, nbr, beam)]
  got = rate_fn(*on_card)
  torch.cuda.synchronize()
  err = float((got.cpu() - want).abs().max())
  # The JAX test's probe: 512 beams in [-1.8, 1.8]^2 around a canonical
  # silicon, against the aligned prior the model was trained from.
  k = 512
  canon = 1.42 * torch.tensor([[1.0, 0.0], [-0.5, 3 ** 0.5 / 2],
                               [-0.5, -(3 ** 0.5) / 2]], device=dev)
  probe = [torch.zeros((k, 2), device=dev), canon.expand(k, 3, 2),
           torch.rand((k, 2), generator=gen).to(dev) * 3.6 - 1.8]
  learned = rate_fn(*probe).flatten()
  analytic = rates_lib.prior_rates_aligned(*probe).flatten()
  corr = float(torch.corrcoef(torch.stack([learned, analytic]))[0, 1])
  t_learned = time_ms(lambda: rate_fn(*on_card))
  t_aligned = time_ms(lambda: rates_lib.prior_rates_aligned(*on_card))
  print(f'rate stack: shipped predictor at ({n}, 3) rows: card against CPU '
        f'max|d| = {err:.3g}; correlation with prior_rates_aligned at {k} '
        f'beams {corr:.4f}; the learned rate function {t_learned:.4f} ms '
        f'per call, prior_rates_aligned {t_aligned:.4f} ms', flush=True)
  check(err <= 1e-5, f'shipped predictor: card against CPU {err}')
  check(corr > 0.95, f'shipped predictor correlation {corr}')
  out.update(predictor_max_abs_err=err, predictor_correlation=corr,
             learned_rate_fn_ms=t_learned, prior_rates_aligned_ms=t_aligned)
  del preds, want, got, on_card

  # -- the entries on small_eval -------------------------------------------------
  for name, bar in RATE_STACK_BARS.items():
    counted = run_eval(name, 0.0 if bar is None else bar, path='rate stack')
    rep = eval_reports[name]
    out[name] = {
        'success': rep['aggregate']['average_num_times_reached_goal'],
        'actions': rep['aggregate']['average_num_actions_taken'],
        'bar': bar,
        'ms_per_step': 1e3 * rep['wall_seconds'] * 100 / rep['env_steps']}
    if name.startswith('vision_'):
      path_launches[f'{name}_512'] = counted
      for kernel in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
        check(counted[kernel] > 0, f'{kernel} was not launched on {name}')
      for kernel in ('splat_render', 'clahe_interp', 'clahe_small'):
        check(counted[kernel] == 0, f'{kernel} launched on a default route')
  try:
    eval_cli.main(eval_cli.Args(
        experiment_name='planner_distilled_prior_variable_time',
        eval_suite='tiny_eval', device='cuda'))
  except FileNotFoundError as e:
    print(f'rate stack: planner_distilled_prior_variable_time raises '
          f'FileNotFoundError ({e})', flush=True)
  else:
    fail('planner_distilled_prior_variable_time ran without its checkpoint')

  # -- the trainer at the shipped widths -----------------------------------------
  with open(os.path.join(shipped, 'config.json')) as f:
    stored = json.load(f)
  stored.pop('num_models_current')
  stored['hidden_dimensions'] = tuple(stored['hidden_dimensions'])
  # Synthetic positions are in bond lengths.
  config = dataclasses.replace(rl_config.RateLearningConfig(**stored),
                               epochs=3, beam_units='bonds')
  gen = torch.Generator(device=dev).manual_seed(0)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  data, _ = rl_data.generate_synthetic_data(num_data=40_960, generator=gen,
                                            device=dev)
  torch.cuda.synchronize()
  t_data = time.perf_counter() - t0
  predictor = rl_predictor.LearnedRatePredictor(config=config, device=dev,
                                                seed=0)
  rows = slice(0, 16_384)
  probe_rows = (data['next_state'][rows].long(), data['dt'][rows],
                data['next_state'][rows] != 0,
                torch.cat([data['context'], data['position']], -1)[rows])

  def data_loss():
    with torch.no_grad():
      loss, _ = rl_losses.batched_loss_fn(predictor.model, *probe_rows,
                                          is_training=False)
    return loss.cpu()

  loss_init = data_loss()
  marks = []
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  metrics = predictor.train(
      data, epoch_chunk=1,
      progress=lambda done, last: marks.append(time.perf_counter()))
  loss_after = data_loss()
  steps = (len(data['dt']) * 6) // config.batch_size
  epoch_s = [b - a for a, b in zip(marks[:-1], marks[1:])]
  first_s = marks[0] - t0
  ms_step = 1e3 * statistics.mean(epoch_s) / steps
  train_loss = metrics['train_loss']
  print(f'rate stack trainer: {config.num_models} models, hidden '
        f'{config.hidden_dimensions}, batch {config.batch_size}, 40960 '
        f'transitions made on the card in {t_data:.2f} s (x6 augmented, '
        f'bootstrapped: {steps} steps an epoch); epoch 1 {first_s:.2f} s '
        f'(with the host splits and the copy to the card), epochs 2-3 '
        f'{", ".join(f"{e:.3f}" for e in epoch_s)} s = {ms_step:.4f} ms a '
        f'step, {1e3 / ms_step:.1f} steps/s; projected 500 epochs '
        f'{500 * statistics.mean(epoch_s):.1f} s; loss on the data (mean '
        f'over models) {float(loss_init.mean()):.4f} at initialisation -> '
        f'{float(loss_after.mean()):.4f}; train loss by epoch '
        f'{[round(float(v), 4) for v in train_loss.mean(0)]}', flush=True)
  check(bool(torch.isfinite(loss_after).all())
        and bool((loss_after < loss_init).all()),
        'trainer: the loss did not fall for every model')
  check(bool(train_loss[:, -1].mean() < float(loss_init.mean())),
        'trainer: the train loss after epoch 3 is not below the loss at '
        'initialisation')
  out.update(trainer_ms_per_step=ms_step, trainer_epoch_s=epoch_s,
             trainer_first_epoch_s=first_s,
             trainer_loss_init=float(loss_init.mean()),
             trainer_loss_after=float(loss_after.mean()))

  # -- distillation at batch 4096 ------------------------------------------------
  distill_config = rl_config.DistillConfig(batch_size=4096, epochs=20,
                                           batches_per_epoch=10)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  history = predictor.distill(data, distill_config)['distill_loss']
  ms_distill = 1e3 * (time.perf_counter() - t0) / 200
  print(f'rate stack distillation: 20 epochs x 10 batches x 4096 in '
        f'{ms_distill:.4f} ms a step; loss {history[0]:.3g} -> '
        f'{history[-1]:.3g}', flush=True)
  check(predictor.num_models == 1 and bool(np.isfinite(history).all()),
        'distillation did not leave one model')
  out['distill_ms_per_step'] = ms_distill

  # -- save -> load on the card ----------------------------------------------------
  with tempfile.TemporaryDirectory() as tmp:
    predictor.save(tmp)
    restored = rl_predictor.LearnedRatePredictor(device=dev)
    restored.load(tmp)
  x = torch.randn((4096, predictor.context_dim), generator=gen, device=dev)
  same = torch.equal(predictor.apply_model(x), restored.apply_model(x))
  print(f'rate stack save -> load: outputs equal {same}', flush=True)
  check(same and restored.num_models == 1, 'save -> load round trip')

  # -- the 2-model recovery probe -------------------------------------------------
  probe_data, _ = rl_data.generate_synthetic_data(
      num_data=2048, generator=gen, device=dev)
  small = rl_predictor.LearnedRatePredictor(
      config=rl_config.RateLearningConfig(batch_size=128, epochs=60,
                                          num_models=2,
                                          hidden_dimensions=(64, 64)),
      device=dev, seed=5)
  t0 = time.perf_counter()
  small.train(probe_data)
  hits = 0
  for j in range(3):
    a = 2.0 * math.pi * j / 3.0
    x = torch.tensor([[0.0, 0.0, 0.85 * math.cos(a), 0.85 * math.sin(a)]],
                     device=dev)
    hits += int(int(torch.argmax(small.apply_model(x)[0])) == j)
  print(f'rate stack recovery probe: {hits} of 3 argmaxes at the prior '
        f'peaks (2 models x 60 epochs, {time.perf_counter() - t0:.2f} s)',
        flush=True)
  check(hits >= 2, f'recovery probe: {hits} of 3')
  out['probe_hits'] = hits
  return out


def time_update(trainer, carry) -> tuple[float, float]:
  """One more PPO update, its two phases timed apart (host clock around
  synchronized work): ms per rollout step and ms per gradient step."""
  import torch

  config = trainer.config
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  traj, last_value = trainer.rollout(carry)
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  trainer.learn(carry, traj, last_value)
  torch.cuda.synchronize()
  t2 = time.perf_counter()
  return (1e3 * (t1 - t0) / config.rollout_length,
          1e3 * (t2 - t1) / (config.num_epochs * config.num_minibatches))


def training(dev, eval_reports, path_launches) -> dict:
  """Phase 18 (see the module docstring); returns the numbers it read. The
  checkpoints it saves go to a temporary directory, removed after."""
  import tempfile

  with tempfile.TemporaryDirectory(prefix='smoke_train_') as tmp:
    return _training(dev, eval_reports, path_launches, tmp)


def _training(dev, eval_reports, path_launches, tmp) -> dict:
  import numpy as np
  import torch

  from putting_dune_torch import eval_lib
  from putting_dune_torch import lattice as lattice_lib
  from putting_dune_torch import rates as rates_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import distill
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.agents import ppo
  from putting_dune_torch.env import multi_dopant
  from putting_dune_torch.ops import _build

  out = {}

  def train_env(name, batch, render=None):
    exp = registry.create_train_experiment(name)
    return run_helpers.create_batched_env(
        exp.get_adapters_and_goal, exp.get_simulator_config,
        batch_size=batch, image_size=render, device=dev)

  def small_eval(env, model):
    agg = eval_lib.aggregate_results(eval_lib.evaluate_batched(
        env, eval_agent.mean_policy(model), eval_lib.EVAL_SUITES['small_eval']))
    return agg.average_num_times_reached_goal, agg.average_num_actions_taken

  # -- 18a. vector PPO at the shipped zoo config ----------------------------
  env = train_env('ppo_learned_2s', 1024)
  config = ppo.PPOConfig(num_updates=PPO_VECTOR_UPDATES, rollout_length=64)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  policy, metrics = ppo.train_and_save(
      env, os.path.join(tmp, 'vector'), config, seed=PPO_VECTOR_SEED,
      updates_per_chunk=PPO_VECTOR_UPDATES // 2, log_every_chunk=True)
  seconds = time.perf_counter() - t0
  rate = metrics['terminal_rate']
  early, late = float(rate[:10].mean()), float(rate[40:50].mean())
  env_steps = len(rate) * config.rollout_length * env.batch_size
  grad_steps = len(rate) * config.num_epochs * config.num_minibatches
  trainer = ppo.PPOTrainer(env, config)
  roll_ms, grad_ms = time_update(trainer, trainer.init_carry(1))
  loaded = eval_agent.load_policy(os.path.join(tmp, 'vector'), dev)
  success, actions = small_eval(train_env('ppo_learned_2s', 100), loaded)
  print(f'training 18a ppo_learned_2s: {len(rate)} updates (batch 1024, '
        f'rollout 64, 4 x 8 minibatches of 8192, hidden (256, 256)) in '
        f'{seconds:.2f} s through train_and_save (chunks of '
        f'{PPO_VECTOR_UPDATES // 2}), {env_steps / seconds:.1f} env steps/s '
        f'overall; one more update timed by phase: {roll_ms:.4f} ms a rollout '
        f'step ({1024e3 / roll_ms:.1f} env steps/s), {grad_ms:.4f} ms a '
        f'gradient step ({1e3 / grad_ms:.1f} steps/s); terminal rate updates '
        f'0-9 {early:.5f}, 40-49 {late:.5f} (bar '
        f'{PPO_TERMINAL_RATE_BAR:.5f}); '
        f'loss {metrics["loss"][0]:.4f} -> {metrics["loss"][-1]:.4f}; '
        f'small_eval success {success}, actions {actions:.2f} (bar '
        f'{PPO_SUCCESS_BAR:.4f})', flush=True)
  check(bool(np.isfinite(metrics['loss']).all()), '18a: loss not finite')
  check(late >= 2.0 * early, '18a: the terminal rate did not double')
  check(late >= PPO_TERMINAL_RATE_BAR, '18a: terminal rate below its bar')
  check(success >= PPO_SUCCESS_BAR, '18a: small_eval success below its bar')
  out['vector'] = dict(updates=len(rate), seconds=seconds,
                       env_steps=env_steps, grad_steps=grad_steps,
                       rollout_ms_per_step=roll_ms, grad_ms_per_step=grad_ms,
                       terminal_rate_0_9=early, terminal_rate_40_49=late,
                       success=success, actions=actions)
  del env, trainer, policy, loaded
  torch.cuda.empty_cache()

  # -- 18b. pixel PPO at the shipped pixel config ---------------------------
  def pixel_run(render, updates):
    """`updates` pixel PPO updates at a `render`^2 render (None: the
    default 512^2), the launches counted from the reset on."""
    env = train_env('relative_simple_rates_from_images', 256, render)
    config = ppo.PPOConfig(num_updates=updates, rollout_length=16,
                           reward_shaping_coef=0.05)
    trainer = ppo.PPOTrainer(env, config)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = trainer.init_carry(0)
    before = ppo.actor_critic_to_flax(carry.model)
    carry, metrics = trainer.run_updates(carry, updates)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = dict(_build.LAUNCHES)
    loss = metrics['loss'].cpu().numpy()
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(before), _leaves(ppo.actor_critic_to_flax(carry.model))))
    steps = updates * config.rollout_length
    print(f'training 18b pixel PPO at {render or 512}^2: {updates} updates '
          f'(batch 256, rollout 16, minibatches of 512 frames, shaping 0.05) in '
          f'{seconds:.2f} s, {steps * 256 / seconds:.1f} env steps/s overall; '
          f'loss {loss.tolist()}; largest parameter move {moved:.3g}; '
          f'launches {counted}', flush=True)
    check(bool(np.isfinite(loss).all()),
          f'18b {render or 512}^2: loss not finite')
    check(moved > 0.0, f'18b {render or 512}^2: the parameters did not move')
    return env, trainer, carry, counted, seconds, steps

  env, trainer, carry, counted, seconds, steps = pixel_run(128, 10)
  path_launches['ppo_pixel_128'] = counted
  # One render a rollout step, and one for the reset.
  check(counted['noise_chain'] == steps + 1 and
        counted['clahe_small'] == steps + 1,
        '18b: noise_chain and clahe_small not once a step and reset')
  for name in ('clahe_hist_lut', 'clahe_remap', 'splat_render',
               'clahe_interp'):
    check(counted[name] == 0, f'18b: {name} launched at the 128^2 render')
  roll_ms, grad_ms = time_update(trainer, carry)
  saved = os.path.join(tmp, 'pixel')
  policy = ppo.as_policy(carry.model, env, trainer.config)
  eval_agent.save_policy(policy, saved)
  loaded = eval_agent.load_policy(saved, dev)
  with torch.no_grad():
    mean = eval_agent.mean_policy(loaded)(None, carry.ts.observation)
  warm = trainer.init_carry(1, eval_agent.read_flax_params(
      os.path.join(saved, 'policy.ckpt')))
  same = all(np.array_equal(a, b) for a, b in zip(
      _leaves(ppo.actor_critic_to_flax(warm.model)),
      _leaves(ppo.actor_critic_to_flax(loaded))))
  print(f'training 18b: one more update timed by phase: {roll_ms:.4f} ms a '
        f'rollout step ({256e3 / roll_ms:.1f} env steps/s), {grad_ms:.4f} ms '
        f'a gradient step; save -> load: mean actions in '
        f'[{float(mean.min()):.3f}, {float(mean.max()):.3f}]; warm start '
        f'holds the checkpoint exactly: {same}', flush=True)
  check(bool(torch.isfinite(mean).all()) and float(mean.abs().max()) <= 1.0,
        '18b: loaded policy actions outside [-1, 1]')
  check(same, '18b: the warm start does not hold the checkpoint')
  out['pixel_128'] = dict(updates=10, seconds=seconds,
                          rollout_ms_per_step=roll_ms,
                          grad_ms_per_step=grad_ms, launches=counted)
  del env, trainer, carry, warm, policy, loaded
  torch.cuda.empty_cache()
  env, trainer, carry, counted, seconds, steps = pixel_run(None, 2)
  path_launches['ppo_pixel_512'] = counted
  for name in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
    check(counted[name] == steps + 1,
          f'18b: {name} not once a step and reset at the 512^2 render')
  check(counted['clahe_small'] == 0, '18b: clahe_small launched at 512^2')
  out['pixel_512'] = dict(updates=2, seconds=seconds, launches=counted)
  del env, trainer, carry
  torch.cuda.empty_cache()

  # -- 18c. multi-dopant PPO at the shipped config ---------------------------
  env = multi_dopant.MultiDopantEnv(
      lattice=lattice_lib.make_lattice(50, dev),
      rate_fn=rates_lib.simple_canonical_rates, batch_size=1024,
      num_dopants=2, dwell_seconds=5.0, device=dev)
  config = ppo.PPOConfig(num_updates=5, rollout_length=64,
                         reward_shaping_coef=0.05)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, metrics = ppo.make_train(env, config)(0)
  metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
  seconds = time.perf_counter() - t0
  print(f'training 18c multi-dopant PPO (batch 1024, 2 dopants, dwell 5 s, '
        f'rollout 64, shaping 0.05): 5 updates in {seconds:.2f} s, '
        f'{seconds / 5:.3f} s an update, '
        f'{5 * 64 * 1024 / seconds:.1f} env steps/s; loss '
        f'{metrics["loss"].tolist()}, terminal rate '
        f'{metrics["terminal_rate"].tolist()}', flush=True)
  check(all(bool(np.isfinite(v).all()) for v in metrics.values()),
        '18c: metrics not finite')
  out['multi_dopant'] = dict(updates=5, seconds=seconds,
                             terminal_rate=metrics['terminal_rate'].tolist())
  del env
  torch.cuda.empty_cache()

  # -- 18d. DAgger distillation at the shipped config -------------------------
  exp = registry.create_eval_experiment('planner_prior_rates')
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=1024,
      device=dev)
  config = distill.DistillConfig(num_iterations=12, rollout_length=64,
                                 sgd_steps_per_iteration=384,
                                 minibatch_size=4096)
  losses = []
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  student = distill.train_and_save(
      env, os.path.join(tmp, 'student'), rates_lib.prior_rates, config,
      seed=0, progress=lambda i, m: losses.append(m['loss']))
  seconds = time.perf_counter() - t0
  eval_env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=100,
      device=dev)
  loaded = eval_agent.load_policy(os.path.join(tmp, 'student'), dev)
  success, actions = small_eval(eval_env, loaded)
  planner_actions = eval_reports['planner_prior_rates']['aggregate'][
      'average_num_actions_taken']
  _, ts = eval_env.reset(torch.Generator(device=dev).manual_seed(3))
  with torch.no_grad():
    same = torch.equal(student(ts.observation), loaded(ts.observation))
  print(f'training 18d DAgger (batch 1024, 12 iterations x 64 steps, 384 SGD '
        f'steps of 4096 each): {seconds:.2f} s; loss by iteration '
        f'{[round(v, 5) for v in losses]}; student on small_eval success '
        f'{success}, actions {actions:.2f} against the live planner\'s '
        f'{planner_actions:.2f} (gate: success >= 0.95, actions <= '
        f'{1.5 * planner_actions:.2f}); save -> load same actions: {same}',
        flush=True)
  check(success >= 0.95, '18d: student success below the ship gate')
  check(actions <= 1.5 * planner_actions,
        '18d: student actions above 1.5x the planner\'s')
  check(same, '18d: the loaded student acts differently')
  out['distill'] = dict(seconds=seconds, losses=losses, success=success,
                        actions=actions, planner_actions=planner_actions)
  return out


def _leaves(tree):
  """The arrays of a nested dict, in key order."""
  if isinstance(tree, dict):
    return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
  return [tree]


def _same_points(a, b) -> bool:
  """Two AtomicGrids hold the same detections (positions to 1e-9)."""
  import numpy as np

  key = lambda g: sorted(zip(np.round(g.atom_positions, 9).tolist(),  # noqa: E731
                             g.atomic_numbers.tolist()))
  return key(a) == key(b)


def _detector_scenes(gen, lattice, count, image_size=256):
  """`count` clean generator scenes (`sample_batch`'s default law) with
  their true atoms: (frames (N, S, S) on the host, [(positions (K, 2) in
  the microscope frame, atomic numbers)])."""
  import torch

  from putting_dune_torch import simulator as simulator_lib
  from putting_dune_torch.imaging import render as render_lib

  config = simulator_lib.SimulatorConfig(image_size=image_size)
  with torch.no_grad():
    state, obs = simulator_lib.reset(gen, lattice, config=config,
                                     batch_size=count, return_window=True)
    image = render_lib.render_stem_image(gen, obs.window, state.fov,
                                         state.imaging, image_size=image_size)
  window = obs.window
  truth = []
  for b in range(count):
    mask = window.mask[b]
    truth.append((window.positions[b][mask].cpu().numpy(),
                   window.atomic_numbers[b][mask].cpu().numpy()))
  return image.cpu().numpy(), truth


def _recall(grid, positions, numbers, radius) -> tuple[int, int]:
  """(true atoms matched by a detection of their species within `radius`,
  true atoms), over the atoms at least 0.05 inside the frame."""
  import numpy as np

  inside = ((positions > 0.05) & (positions < 0.95)).all(-1)
  matched = 0
  for pos, num in zip(positions[inside], numbers[inside]):
    same = grid.atom_positions[grid.atomic_numbers == num]
    if len(same) and np.linalg.norm(same - pos, axis=1).min() < radius:
      matched += 1
  return matched, int(inside.sum())


@contextlib.contextmanager
def _recording_inputs(recorded):
  """While open, the loop's kernel wrappers record the arguments of their
  first call at each frame shape into recorded[(name, shape)], and launch
  and count as ever."""
  import inspect

  import torch

  from putting_dune_torch.ops import clahe_fused
  from putting_dune_torch.ops import noise_fused

  targets = ((noise_fused, 'noise_chain'), (clahe_fused, 'clahe_small'),
             (clahe_fused, 'clahe_hist_lut'))

  def recording(name, original):
    signature = inspect.signature(original)

    def wrapper(*args, **kwargs):
      bound = signature.bind(*args, **kwargs)
      bound.apply_defaults()
      key = (name, tuple(bound.arguments['image'].shape))
      if key not in recorded:
        recorded[key] = {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in bound.arguments.items()}
      return original(*args, **kwargs)

    return wrapper

  originals = [getattr(module, name) for module, name in targets]
  for (module, name), original in zip(targets, originals):
    setattr(module, name, recording(name, original))
  try:
    yield
  finally:
    for (module, name), original in zip(targets, originals):
      setattr(module, name, original)


def _hold_noise_chain(dev, args, label, gen) -> float:
  """noise_chain on recorded inputs against its twin: injected draws
  within 1e-5, and in Philox mode against the twin fed `draws_from_seeds`
  (at most 1e-5 of the pixels may differ). Returns the injected max|d|."""
  import torch

  from putting_dune_torch.ops import noise_fused

  x, packed = args['image'], args['packed']
  b, h, w = x.shape
  draws = noise_fused.sample_draws(gen, b, h, w, dev)
  injected = float((noise_fused.noise_chain(x, packed, draws=draws)
                    - noise_fused.noise_chain_reference(x, packed,
                                                        draws=draws))
                   .abs().max())
  seeds = torch.randint(0, 2**62, (b,), generator=gen, device=dev)
  got = noise_fused.noise_chain(x, packed, seeds=seeds)
  want = noise_fused.noise_chain_reference(
      x, packed, draws=noise_fused.draws_from_seeds(seeds, b, h, w, dev))
  differ = int((got != want).sum())
  print(f'{label} noise_chain {tuple(x.shape)}: injected draws max|d| '
        f'{injected:.3g} (bar 1e-5); philox draws against the twin fed '
        f'draws_from_seeds: max|d| {float((got - want).abs().max()):.3g}, '
        f'{differ} of {got.numel()} pixels differ', flush=True)
  check(injected <= 1e-5, f'{label}: noise_chain differs from its twin at '
        f'{tuple(x.shape)}')
  check(differ <= 1e-5 * got.numel(), f'{label}: noise_chain philox mode '
        f'differs from its twin at {tuple(x.shape)}')
  return injected


def _hold_clahe_small(x, kw, label) -> float:
  """clahe_small against its twins: histograms equal, output within
  2e-5 of `clahe_reference`. Returns the output's max|d|."""
  import torch

  from putting_dune_torch.ops import clahe_fused

  out, hist = clahe_fused.clahe_small(x, **kw, return_hist=True)
  want_hist, _ = clahe_fused.hist_lut_reference(
      x, kw['grid_size'], kw['clip_limit'], kw['nbins'])
  err = float((out - clahe_fused.clahe_reference(x, **kw)).abs().max())
  same = bool(torch.equal(hist, want_hist))
  print(f'{label}: histograms {"equal" if same else "DIFFER"}, max|d| '
        f'{err:.3g} (bar 2e-5)', flush=True)
  check(same and err <= 2e-5, f'{label}: clahe_small differs from its twin')
  return err


def _hold_clahe_pair(args, label) -> float:
  """clahe_hist_lut + clahe_remap against their twins: histograms equal,
  mapping and output within 2e-5. Returns the output's max|d|."""
  import torch

  from putting_dune_torch.ops import clahe_fused

  x = args['image']
  kw = {k: args[k] for k in ('grid_size', 'clip_limit', 'nbins')}
  hist, mapping = clahe_fused.clahe_hist_lut(x, **kw)
  want_hist, want_mapping = clahe_fused.hist_lut_reference(x, **kw)
  out = clahe_fused.clahe_remap(x, mapping)
  map_err = float((mapping - want_mapping).abs().max())
  err = float((out - clahe_fused.clahe_reference(x, **kw)).abs().max())
  same = bool(torch.equal(hist, want_hist))
  print(f'{label} {tuple(x.shape)}: histograms '
        f'{"equal" if same else "DIFFER"}, mapping max|d| {map_err:.3g}, '
        f'output max|d| {err:.3g} (bar 2e-5)', flush=True)
  check(same and map_err <= 2e-5 and err <= 2e-5,
        f'{label}: the clahe pair differs from its twins at {tuple(x.shape)}')
  return err


def _recorded(recorded, name, shape, phase):
  args = recorded.get((name, shape))
  check(args is not None, f'{phase}: the path gave {name} no {shape} frame')
  return args


def _hold_loop_kernels(dev, recorded, aligner_frame) -> dict:
  """Phase 19g (see the module docstring): max|d| of each hold."""
  import torch

  gen = torch.Generator(device=dev).manual_seed(19)
  errs = {}
  for size in (128, 512):
    args = _recorded(recorded, 'noise_chain', (1, size, size), '19g')
    errs[f'noise_chain_{size}'] = _hold_noise_chain(
        dev, args, "19g on the loop's clean render:", gen)
  render = _recorded(recorded, 'clahe_small', (1, 128, 128), '19g')
  kw = {k: render[k] for k in ('clip_limit', 'grid_size', 'nbins')}
  frame = torch.as_tensor(aligner_frame, dtype=torch.float32, device=dev)
  for label, x in (('a render', render['image']),
                   ('an aligner frame', frame[None].contiguous())):
    errs[f'clahe_small_128 {label}'] = _hold_clahe_small(
        x, kw, f'19g clahe_small (1, 128, 128) on {label}')
  errs['clahe_pair_512'] = _hold_clahe_pair(
      _recorded(recorded, 'clahe_hist_lut', (1, 512, 512), '19g'),
      '19g clahe_hist_lut + clahe_remap on a render')
  return errs


def hardware_loop(dev, smi, path_launches) -> dict:
  """Phase 19 (see the module docstring); returns the numbers it read."""
  import tempfile

  recorded = {}
  with tempfile.TemporaryDirectory(prefix='smoke_loop_') as tmp:
    with _recording_inputs(recorded):
      out, aligner_frame = _hardware_loop(dev, smi, path_launches, tmp)
  out['twins'] = _hold_loop_kernels(dev, recorded, aligner_frame)
  return out


def _hardware_loop(dev, smi, path_launches, tmp):
  import numpy as np
  import torch
  import torch.nn.functional as F

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import lattice as lattice_lib
  from putting_dune_torch import microscope_agent
  from putting_dune_torch import microscope_data as md
  from putting_dune_torch import registry
  from putting_dune_torch.agents import vision_planner
  from putting_dune_torch.atom_detection import inference as detection
  from putting_dune_torch.image_alignment import inference as alignment
  from putting_dune_torch.imaging import clahe as clahe_lib
  from putting_dune_torch.ops import _build
  from putting_dune_torch.pipeline import align_trajectories

  out = {}
  torch.set_num_threads(8)

  # -- 19a. the shipped aligner on the card against the port on the CPU ------
  t0 = time.perf_counter()
  aligner = alignment.ImageAligner.from_checkpoint(device=dev)
  cpu_aligner = alignment.ImageAligner.from_checkpoint(device='cpu')
  load_s = time.perf_counter() - t0
  sequence, _ = microscope_agent.drifting_sequence(ALIGNMENT_SEEDS[0],
                                                   device=dev)
  aligner.reset()
  cpu_aligner.reset()
  _build.reset_launches()
  drift_err = prob_err = 0.0
  same_sets = 0
  call_ms = []
  for obs in sequence:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, drift, probs = aligner(obs.image, obs.fov)
    torch.cuda.synchronize()
    call_ms.append(1e3 * (time.perf_counter() - t0))
    card_drifts = aligner.last_drifts
    cpu_grid, _, cpu_probs = cpu_aligner(obs.image, obs.fov)
    drift_err = max(drift_err, float(np.abs(
        card_drifts - cpu_aligner.last_drifts).max()))
    prob_err = max(prob_err, float(np.abs(probs - cpu_probs).max()))
    same_sets += _same_points(grid, cpu_grid)
  counted = dict(_build.LAUNCHES)
  path_launches['aligner_128'] = counted
  # The whole local head (S, S, T, 3) on one stack of the sequence's frames.
  stack = np.concatenate([cpu_aligner.preprocess(o.image)
                          for o in sequence[-5:]], axis=-1)
  logits_err = max(
      float((a.cpu() - b).abs().max()) for a, b in zip(
          aligner.forward(stack), cpu_aligner.forward(stack)))
  stack = torch.as_tensor(stack, device=dev)
  forward_ms = time_ms(lambda: aligner.forward(stack), repeats=20)
  print(f'19a aligner (features (64, 128, 256, 512), 5 frames, 128^2), '
        f'{len(sequence)} frames of a drifting sequence: card against the '
        f'CPU: drift heads max|d| {drift_err:.3g} A (bar 1e-4), queried '
        f'probabilities max|d| {prob_err:.3g} (bar 1e-3), local logits and '
        f'drifts of one stack max|d| {logits_err:.3g} (bar 1e-3), detections '
        f'equal on {same_sets} of {len(sequence)} frames; launches '
        f'{counted}; '
        f'forward {forward_ms:.3f} ms, whole call '
        f'{statistics.median(call_ms):.3f} ms a frame (median; CLAHE, '
        f'resize, stack, forward, centroids), loaded both in {load_s:.2f} s '
        f'on {smi}', flush=True)
  check(drift_err <= 1e-4, '19a: aligner drifts on the card differ from CPU')
  check(prob_err <= 1e-3, '19a: aligner probabilities differ from CPU')
  check(logits_err <= 1e-3, '19a: aligner logits differ from CPU')
  check(same_sets == len(sequence), '19a: aligner detections differ')
  check(counted['clahe_small'] == len(sequence),
        '19a: clahe_small not launched once an aligner frame')
  # One real-size frame, 1000 x 1000: padded to 1008^2 -> the split pair.
  big = F.interpolate(torch.as_tensor(sequence[-1].image, device=dev)[
      None, None], size=(1000, 1000), mode='bilinear',
                      align_corners=False)[0, 0]
  big = torch.clamp(big + 0.02 * torch.randn(
      big.shape, generator=torch.Generator(device=dev).manual_seed(1),
      device=dev), 0.0, 1.0).contiguous()
  padded = clahe_lib.equalize_adapthist_padded(big[None])
  twin = clahe_lib.equalize_adapthist_padded(big[None].cpu())
  clahe_err = float((padded.cpu() - twin).abs().max())
  _build.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  aligner(big.cpu().numpy(), sequence[-1].fov)
  torch.cuda.synchronize()
  big_ms = 1e3 * (time.perf_counter() - t0)
  counted = dict(_build.LAUNCHES)
  path_launches['aligner_1000'] = counted
  print(f'19a aligner on one 1000 x 1000 frame (1008^2 padded CLAHE): '
        f'{big_ms:.2f} ms, launches {counted}; padded CLAHE against its '
        f'twin max|d| {clahe_err:.3g} (bar 2e-5)', flush=True)
  check(counted['clahe_hist_lut'] == 1 and counted['clahe_remap'] == 1,
        '19a: the 1000^2 frame did not take the split pair once')
  check(clahe_err <= 2e-5, '19a: padded CLAHE differs from its twin')
  out['aligner'] = dict(drift_err=drift_err, prob_err=prob_err,
                        logits_err=logits_err,
                        forward_ms=forward_ms,
                        call_ms=statistics.median(call_ms),
                        big_frame_ms=big_ms, clahe_err=clahe_err)

  # -- 19b. do_alignment recovers the simulator's own drift ------------------
  inc_errs, err_aligned, err_nothing = [], [], []
  fov_err, cpu_s = 0.0, 0.0
  align_args = align_trajectories.Args(
      source_path='', target_path='',
      aligner_workdir=alignment.SHIPPED_ALIGNER_DIR)
  for seed in ALIGNMENT_SEEDS:
    obs, true_drift = microscope_agent.drifting_sequence(seed, device=dev)
    trajectory = md.Trajectory(tuple(obs))
    aligned = align_trajectories.do_alignment(
        trajectory, align_args, aligner)
    t0 = time.perf_counter()
    on_cpu = align_trajectories.do_alignment(
        trajectory, align_args, cpu_aligner)
    cpu_s += time.perf_counter() - t0
    for a, c in zip(aligned.observations, on_cpu.observations):
      fov_err = max(fov_err, float(np.abs(np.concatenate([
          a.fov.lower_left - c.fov.lower_left,
          a.fov.upper_right - c.fov.upper_right])).max()))
    recovered = np.stack([a.fov.lower_left - o.fov.lower_left
                          for a, o in zip(aligned.observations, obs)])
    inc_errs.append(float(np.linalg.norm(
        np.diff(-recovered, axis=0) - np.diff(true_drift, axis=0),
        axis=1).mean()))
    err_aligned.append(float(np.linalg.norm(
        recovered + true_drift, axis=1)[-3:].mean()))
    err_nothing.append(float(np.linalg.norm(true_drift, axis=1)[-3:].mean()))
  inc_err = float(np.mean(inc_errs))
  last3, last3_off = float(np.mean(err_aligned)), float(np.mean(err_nothing))
  share = float(np.mean(np.asarray(err_aligned) < 0.8 * np.asarray(
      err_nothing)))
  print(f'19b do_alignment, {len(ALIGNMENT_SEEDS)} sequences of 12 frames at '
        f'0.5 A a frame: recovered FOVs on the card against the CPU max|d| '
        f'{fov_err:.3g} A (bar {ALIGNMENT_FOV_TOL}; the CPU in {cpu_s:.2f} '
        f's); mean increment error {inc_err:.4f} A (bar 0.35), '
        f'mean last-three error {last3:.4f} A (bar {ALIGNMENT_LAST3_BAR:.4f}, '
        f'the JAX mean {ALIGNMENT_JAX_LAST3[0]} plus three standard errors) '
        f'against {last3_off:.4f} uncorrected; below 0.8x uncorrected on '
        f'{share:.3f} of the sequences (JAX on the CPU 0.29)', flush=True)
  check(fov_err <= ALIGNMENT_FOV_TOL,
        '19b: do_alignment on the card differs from the CPU')
  check(inc_err < 0.35, '19b: increment error above 0.35 A')
  check(last3 <= ALIGNMENT_LAST3_BAR,
        '19b: last-three error above the JAX package\'s')
  out['do_alignment'] = dict(fov_err=fov_err, inc_err=inc_err, last3=last3,
                             last3_uncorrected=last3_off, share_08=share)

  # -- 19c. the rehearsal: microscope -> aligner -> MicroscopeAgent ---------
  experiment = registry.create_microscope_experiment('greedy_on_neighbor')
  _build.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()

  def rehearse(seed, correct):
    mic = microscope_agent.SimulatedMicroscope(
        seed=seed, drift_per_frame_angstroms=0.5, image_size=128, device=dev)
    rng = np.random.default_rng(seed)
    agent = microscope_agent.MicroscopeAgent(rng, experiment, device=dev)
    return microscope_agent.rehearse(
        mic, agent, rng, aligner if correct else None, steps=REHEARSAL_STEPS)

  rows, mode_s = [], {True: 0.0, False: 0.0}
  for seed in range(REHEARSAL_SEEDS):
    row = {}
    for correct in (True, False):
      t1 = time.perf_counter()
      row[correct] = rehearse(seed, correct)
      torch.cuda.synchronize()
      mode_s[correct] += time.perf_counter() - t1
    rows.append(row)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  counted = dict(_build.LAUNCHES)
  path_launches['rehearsal_128'] = counted
  reach = sum(r[True][0] < 0.72 for r in rows) / len(rows)
  reach_off = sum(r[False][0] < 0.72 for r in rows) / len(rows)
  final = float(np.mean([r[True][1] for r in rows]))
  final_off = float(np.mean([r[False][1] for r in rows]))
  renders = REHEARSAL_SEEDS * 2 * (REHEARSAL_STEPS + 1)
  frames = REHEARSAL_SEEDS * REHEARSAL_STEPS
  print(f'19c rehearsal, {REHEARSAL_SEEDS} seeds x {REHEARSAL_STEPS} steps, '
        f'corrected and uncorrected, in {seconds:.2f} s on {smi}: the true '
        f'silicon within 0.72 A of the goal on {reach:.3f} of the seeds '
        f'corrected (bar {REHEARSAL_REACH_BAR:.4f}; the JAX package on the '
        f'CPU {REHEARSAL_JAX_REACH}), {reach_off:.3f} uncorrected; mean final '
        f'distance {final:.3f} A corrected, {final_off:.3f} uncorrected '
        f'(the JAX package on the CPU {REHEARSAL_JAX_FINAL}); launches '
        f'{counted} ({renders} renders + {frames} aligner frames)',
        flush=True)
  check(reach >= REHEARSAL_REACH_BAR, '19c: rehearsal reach share below bar')
  check(counted['clahe_small'] == renders + frames,
        '19c: clahe_small not launched once a render and an aligner frame')
  check(counted['noise_chain'] == renders, '19c: noise_chain launches')
  step_ms = {c: 1e3 * mode_s[c] / (REHEARSAL_SEEDS * REHEARSAL_STEPS)
             for c in mode_s}
  _, busy = busy_share(lambda: rehearse(REHEARSAL_SEEDS, True))
  print(f'19c a rehearsal step: {step_ms[True]:.3f} ms corrected, '
        f'{step_ms[False]:.3f} ms uncorrected (reset included); device busy '
        f'share corrected {busy:.3f} (one more seed under torch.profiler) on '
        f'{smi}', flush=True)
  out['rehearsal'] = dict(seconds=seconds, reach=reach, reach_off=reach_off,
                          final=final, final_off=final_off, step_ms=step_ms,
                          busy=busy)

  # -- 19d. AtomDetector on the card against the port on the CPU -------------
  detector = detection.AtomDetector.from_checkpoint(
      vision_planner.SHIPPED_DETECTOR_DIR, device=dev)
  cpu_detector = detection.AtomDetector.from_checkpoint(
      vision_planner.SHIPPED_DETECTOR_DIR, device='cpu')
  lat = lattice_lib.make_lattice(50, dev)
  images, truth = _detector_scenes(
      torch.Generator(device=dev).manual_seed(5), lat, DETECTOR_FRAMES)
  equal, matched, total, det_ms = 0, 0, 0, []
  for image, (positions, numbers) in zip(images, truth):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = detector(image)
    det_ms.append(1e3 * (time.perf_counter() - t0))
    equal += _same_points(grid, cpu_detector(image))
    m, n = _recall(grid, positions, numbers, radius=3.0 / 256)
    matched, total = matched + m, total + n
  share = equal / len(images)
  print(f'19d AtomDetector (features (32, 64, 128, 256), 256^2) on '
        f'{len(images)} clean generator scenes: detections equal to the CPU '
        f'port on {share:.3f} of the frames (bar 0.99); recall '
        f'{matched / total:.4f} ({matched} of {total} true atoms 0.05 inside '
        f'the frame within 3 pixels, same species); '
        f'{statistics.median(det_ms):.3f} ms a frame (median) on {smi}',
        flush=True)
  check(share >= 0.99, '19d: detector detections differ from the CPU')
  out['detector'] = dict(equal_share=share, recall=matched / total,
                         ms=statistics.median(det_ms))

  # -- 19e. every microscope experiment drives the simulated microscope -----
  control_range = [np.inf, -np.inf]
  for name in registry.microscope_experiment_names():
    mic = microscope_agent.SimulatedMicroscope(seed=3, device=dev)
    rng = np.random.default_rng(0)
    agent = microscope_agent.MicroscopeAgent(
        rng, registry.create_microscope_experiment(name), device=dev)
    obs = mic.reset()
    agent.reset(rng, obs)
    try:
      for _ in range(5):
        controls = agent.step(obs)
        for c in controls:
          control_range = [min(control_range[0], float(c.position.min())),
                           max(control_range[1], float(c.position.max()))]
        obs = mic.apply(controls)
    except RuntimeError as e:
      # The JAX package raises here too: an image policy fed the 10-dim
      # features of MicroscopeAgent.
      check(name == 'ppo_simple_images_tf' and '16386' in str(e),
            f'19e: {name} raised {e}')
      print(f'19e {name}: raises as in the JAX package ({e})', flush=True)
  print(f'19e: {len(registry.microscope_experiment_names())} microscope '
        f'experiments, 5 steps each; controls in [{control_range[0]:.4f}, '
        f'{control_range[1]:.4f}]', flush=True)
  check(0.0 <= control_range[0] and control_range[1] <= 1.0,
        '19e: controls outside [0, 1]^2')

  # -- 19f. the host eval entry point, --nobatched ---------------------------
  host = {}
  for name, bar, key in (('greedy_simple_rates', 1.0, None),
                         ('ppo_simple_images_tf', 0.9, 'host_pixel_512')):
    path = os.path.join(tmp, f'{name}.json')
    _build.reset_launches()
    rep = eval_cli.main(eval_cli.Args(
        experiment_name=name, eval_suite='tiny_eval', batched=False,
        output_json=path, device=str(dev)))
    counted = dict(_build.LAUNCHES)
    with open(path) as f:
      payload = json.load(f)
    a = rep['aggregate']
    steps = sum(r.num_actions_taken for r in rep['results'])
    print(f"19f host eval {name} tiny_eval --nobatched: success "
          f"{a['average_num_times_reached_goal']}, actions "
          f"{a['average_num_actions_taken']:.2f}, {rep['env_steps']} env "
          f"steps in {rep['wall_seconds']:.2f} s = "
          f"{rep['env_steps'] / rep['wall_seconds']:.1f} env steps/s at batch "
          f"1 on {smi}; launches {counted}; --output_json keys "
          f"{sorted(payload)}", flush=True)
    check(a['average_num_times_reached_goal'] >= bar,
          f'19f: {name} host success below {bar}')
    check(sorted(payload) == ['aggregate', 'experiment', 'results', 'suite']
          and len(payload['results']) == 10, f'19f: {name} output_json')
    if key:
      path_launches[key] = counted
      # One render a step plus one a reset: noise_chain and the pair.
      for kernel in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
        check(counted[kernel] == steps + 10,
              f'19f: {kernel} not launched once a render on {name}')
    host[name] = dict(success=a['average_num_times_reached_goal'],
                      actions=a['average_num_actions_taken'],
                      steps_per_s=rep['env_steps'] / rep['wall_seconds'])
    if key:
      _, host[name]['busy'] = busy_share(lambda: eval_cli.main(eval_cli.Args(
          experiment_name=name, eval_suite='tiny_eval', batched=False,
          device=str(dev))))
      print(f"19f host eval {name}: device busy share {host[name]['busy']:.3f}"
            f' (one more tiny_eval run under torch.profiler)', flush=True)
  out['host_eval'] = host
  return out, sequence[-1].image


def device_kernels(fn) -> int:
  """Device operations (kernels, copies, fills) one call of fn runs, from a
  torch.profiler CUDA trace."""
  import torch
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile

  overhead = ('Command Buffer Full', 'Buffer Flush', 'Activity Buffer Request')
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  return sum(e.count for e in prof.key_averages()
             if e.device_time_total > 0 and e.key not in overhead)


def _hold_adamw_step(label, state, step, batch) -> float:
  """One train step of a trained state on the card, every parameter held
  to optax's AdamW update computed in float64 from the optimizer's moments
  before the step and the card's gradients: m = b1 m + (1 - b1) g, v = b2 v
  + (1 - b2) g^2, p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) +
  wd p). Within 1e-3 lr plus 2^-22 |p| (float32 rounding): a step that
  moves nothing, or moves by another rule, is off by about lr. Returns the
  largest error in units of lr."""
  import torch

  opt = state.optimizer
  (group,) = opt.param_groups
  lr, wd, eps = group['lr'], group['weight_decay'], group['eps']
  b1, b2 = group['betas']
  before = {}
  for p in state.model.parameters():
    moments = opt.state.get(p, {})
    before[p] = [p.detach().double()] + [
        moments[k].double() if k in moments else torch.zeros_like(
            p, dtype=torch.float64) for k in ('exp_avg', 'exp_avg_sq')] + [
                float(moments.get('step', 0))]
  step(batch)
  worst = 0.0
  for p, (p0, m, v, t) in before.items():
    g = p.grad.double()
    t += 1
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    want = p0 - lr * (m / (1 - b1**t) / (torch.sqrt(v / (1 - b2**t)) + eps)
                      + wd * p0)
    err = (p.detach().double() - want).abs()
    check(bool((err <= 1e-3 * lr + 2.0**-22 * p0.abs()).all()),
          f'20 {label}: a parameter did not take the AdamW step (max '
          f'error {float(err.max()) / lr:.3g} lr)')
    worst = max(worst, float(err.max()) / lr)
  print(f'20 {label}: one train step of the trained state takes AdamW\'s '
        f'update on every parameter (max error {worst:.3g} lr, lr {lr:g}, '
        f'step {int(t)})', flush=True)
  return worst


def _time_train_step(label, smi, state, step, stream, tf32_step=None) -> dict:
  """The AdamW check above on one fixed batch, then ms of a train step on
  it (CUDA events, median of 10), of the data step that makes a batch
  apart, the device busy share of three steps with their data, the device
  operations of one step, and the peak device memory of the full-f32
  steps."""
  import torch

  batch = next(stream)
  adamw_err = _hold_adamw_step(label, state, step, batch)
  torch.cuda.reset_peak_memory_stats()
  out = {'adamw_err_lr': adamw_err,
         'data_ms': time_ms(lambda: next(stream), repeats=10, warmup=2),
         'step_ms': time_ms(lambda: step(batch), repeats=10, warmup=2),
         'peak_gb': torch.cuda.max_memory_allocated() / 1e9}
  if tf32_step is not None:
    out['step_tf32_ms'] = time_ms(lambda: tf32_step(batch), repeats=10,
                                  warmup=2)
  wall, out['busy'] = busy_share(
      lambda: [step(next(stream)) for _ in range(3)])
  out['step_device_ops'] = device_kernels(lambda: step(batch))
  out['data_device_ops'] = device_kernels(lambda: next(stream))
  tf32 = (f", TF32 {out['step_tf32_ms']:.3f} ms" if tf32_step is not None
          else '')
  print(f"20 {label}: train step {out['step_ms']:.3f} ms full f32{tf32}; "
        f"data step {out['data_ms']:.3f} ms; busy share {out['busy']:.3f} "
        f"over 3 steps with their data ({wall:.3f} s); device ops "
        f"{out['step_device_ops']} a train step, {out['data_device_ops']} a "
        f"data step; peak memory {out['peak_gb']:.2f} GB; on {smi}",
        flush=True)
  return out


def perception_training(dev, smi, path_launches) -> dict:
  """Phase 20 (see the module docstring); returns the numbers it read. Its
  workdirs are a temporary directory, removed after."""
  import tempfile

  recorded = {}
  with tempfile.TemporaryDirectory(prefix='smoke_perception_') as tmp:
    with _recording_inputs(recorded):
      out = _perception_training(dev, smi, path_launches, tmp)
  out['twins'] = _hold_trainer_kernels(dev, recorded)
  return out


def _perception_training(dev, smi, path_launches, tmp) -> dict:
  import numpy as np
  import torch

  from putting_dune_torch.agents import vision_planner
  from putting_dune_torch.atom_detection import data as det_data
  from putting_dune_torch.atom_detection import inference as det_inference
  from putting_dune_torch.atom_detection import model as det_model
  from putting_dune_torch.atom_detection import train as det_train
  from putting_dune_torch.graph_alignment import data as graph_data
  from putting_dune_torch.graph_alignment import model as graph_model
  from putting_dune_torch.graph_alignment import train as graph_train
  from putting_dune_torch.image_alignment import data as align_data
  from putting_dune_torch.image_alignment import inference as align_inference
  from putting_dune_torch.image_alignment import model as align_model
  from putting_dune_torch.image_alignment import train as align_train
  from putting_dune_torch.io import serialization
  from putting_dune_torch.ops import _build
  from putting_dune_torch.utils import training

  out = {}
  # Deterministic cuDNN algorithms, so that equal weights give equal bits.
  exact = dict(enabled=True, benchmark=False, deterministic=True,
               allow_tf32=False)
  counted = {}

  def count_launches():
    for name, n in _build.LAUNCHES.items():
      counted[name] = counted.get(name, 0) + n

  # -- 20a. the detector: the shipped noise-robust fine-tune -------------------
  t0 = time.perf_counter()
  shipped_dir = vision_planner.SHIPPED_DETECTOR_DIR
  config = det_train.Config(
      workdir=os.path.join(tmp, 'det'), image_size=256, batch_size=32,
      epochs=2, steps_per_epoch=8, eval_steps=4, noisy_images=True,
      noisy_fraction=0.4, class_weights=(0.2, 1.0, 10.0), learning_rate=1e-4,
      features=tuple(det_train.load_arch(shipped_dir)['features']),
      init_params_from=shipped_dir, seed=13)
  evals = det_data.dataset_iterator(PERCEPTION_EVAL_SEED, batch_size=32,
                                    image_size=256, noisy=True, device=dev)
  eval_batches = [next(evals) for _ in range(PERCEPTION_EVAL_BATCHES)]
  shipped = det_train.create_state(config, dev)
  shipped.model.load_state_dict(det_model.params_from_flax(
      det_train.load_params(shipped_dir)))
  accuracy = lambda s: float(torch.stack(  # noqa: E731
      [det_train.eval_step(s, b) for b in eval_batches]).mean())
  acc_shipped = accuracy(shipped)
  history = []
  _build.reset_launches()
  t1 = time.perf_counter()
  state = det_train.train(config, device=dev,
                          progress=lambda e, m: history.append(m))
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t1
  count_launches()
  acc_trained = accuracy(state)
  print(f'20a detector fine-tune (features {config.features}, 256^2, batch '
        f'32, 2 x 8 steps, 4 eval steps): {train_s:.2f} s; epochs '
        f'{json.dumps(history)}; pixel accuracy on {len(eval_batches)} fixed '
        f'noisy batches: shipped {acc_shipped:.4f}, fine-tuned '
        f'{acc_trained:.4f} (bar {DETECTOR_FINETUNE_BAR:.4f}); launches '
        f'{dict(_build.LAUNCHES)}', flush=True)
  check(all(np.isfinite(m['loss']) for m in history),
        '20a: detector loss not finite')
  check(acc_trained >= DETECTOR_FINETUNE_BAR,
        '20a: the fine-tuned detector is below its accuracy bar')
  # The kept checkpoint best_fn picks (orbax: ties to the later step).
  manager = training.manager(config.workdir, det_train.best_fn)
  top = max(m['accuracy'] for m in history)
  want_best = max(e for e, m in enumerate(history) if m['accuracy'] == top)
  check(manager.best_step() == want_best,
        f'20a: best checkpoint {manager.best_step()}, best_fn {want_best}')
  restored = det_model.params_from_flax(det_train.load_params(config.workdir))
  check(all(torch.equal(restored[k], v.cpu()) for k, v in
            manager.restore(want_best)['model'].items()),
        '20a: load_params is not the best checkpoint')
  # save_params_msgpack -> AtomDetector: the trained logits, bit for bit.
  art = os.path.join(tmp, 'det_artifact')
  os.makedirs(art)
  det_train.save_params_msgpack(state.model, art, config)
  detector = det_inference.AtomDetector.from_checkpoint(art, device=dev)
  x = eval_batches[0]['image'][:8]
  with torch.no_grad(), torch.backends.cudnn.flags(**exact):
    trained, reloaded = state.model(x), detector.module(x)
  same = torch.equal(trained, reloaded)
  print(f'20a save_params_msgpack -> AtomDetector: logits '
        f'{"equal" if same else "DIFFER"} (max|d| '
        f'{float((trained - reloaded).abs().max()):.3g}); best checkpoint '
        f'step {want_best} restored', flush=True)
  check(same, '20a: the saved detector does not give the trained logits')
  stream = det_data.dataset_iterator(
      7, batch_size=32, image_size=256, noisy=True, device=dev)
  cw = config.class_weights
  out['detector'] = dict(
      shipped_accuracy=acc_shipped, trained_accuracy=acc_trained,
      train_seconds=train_s, **_time_train_step(
          'detector (32, 256, 256, 1)', smi, state,
          lambda b: det_train.train_step(state, b, cw),
          stream,
          lambda b: det_train.train_step(state, b, cw, allow_tf32=True)))
  print(f'20a: {time.perf_counter() - t0:.1f} s', flush=True)

  # -- 20b. the image aligner: the shipped registration fine-tune -------------
  t0 = time.perf_counter()
  shipped_dir = align_inference.SHIPPED_ALIGNER_DIR
  arch = align_train.load_arch(shipped_dir)
  config = align_train.Config(
      workdir=os.path.join(tmp, 'align'), image_size=128, batch_size=32,
      epochs=1, steps_per_epoch=8, eval_steps=4,
      num_frames=arch['num_frames'], features=tuple(arch['features']),
      registration_noise=0.35, inference_preprocessing=True,
      seed_fraction=0.25, init_params_from=shipped_dir)
  stacks = dict(batch_size=32, image_size=128, num_frames=config.num_frames,
                registration_noise=0.35, inference_preprocessing=True,
                seed_fraction=0.25, device=dev)
  evals = align_data.dataset_iterator(PERCEPTION_EVAL_SEED, **stacks)
  eval_batches = [next(evals) for _ in range(PERCEPTION_EVAL_BATCHES)]
  shipped = align_train.create_state(config, dev)
  shipped.model.load_state_dict(align_model.params_from_flax(
      align_train.load_params(shipped_dir)))
  drift_error = lambda s: float(torch.stack([  # noqa: E731
      align_train.eval_step(s, b, config.num_frames, False)['drift_error']
      for b in eval_batches]).mean())
  err_shipped = drift_error(shipped)
  history = []
  _build.reset_launches()
  t1 = time.perf_counter()
  state = align_train.train(config, device=dev,
                            progress=lambda e, m: history.append(m))
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t1
  count_launches()
  err_trained = drift_error(state)
  print(f'20b aligner fine-tune (features {config.features}, 128^2, 5 '
        f'frames, batch 32, 8 steps, 4 eval steps): {train_s:.2f} s; '
        f'{json.dumps(history)}; drift error on {len(eval_batches)} fixed '
        f'stacks: shipped {err_shipped:.4f} A, fine-tuned {err_trained:.4f} '
        f'A (bar {ALIGNER_FINETUNE_BAR:.4f}); launches '
        f'{dict(_build.LAUNCHES)}', flush=True)
  check(np.isfinite(err_trained) and err_trained <= ALIGNER_FINETUNE_BAR,
        '20b: the fine-tuned aligner is above its drift-error bar')
  art = os.path.join(tmp, 'align_artifact')
  os.makedirs(art)
  align_train.save_params_msgpack(state.model, art, config)
  reloaded = align_model.from_flax(align_train.load_params(art)).to(dev)
  x = eval_batches[0]['images'][:8]
  with torch.no_grad(), torch.backends.cudnn.flags(**exact):
    same = all(torch.equal(a, b) for a, b in zip(state.model(x),
                                                 reloaded(x)))
  print(f'20b save_params_msgpack -> from_flax: both heads '
        f'{"equal" if same else "DIFFER"}', flush=True)
  check(same, '20b: the saved aligner does not give the trained outputs')
  stream = align_data.dataset_iterator(7, **stacks)
  out['aligner'] = dict(
      shipped_drift_error=err_shipped, trained_drift_error=err_trained,
      train_seconds=train_s, **_time_train_step(
          'aligner (32, 128, 128, 5)', smi, state,
          lambda b: align_train.train_step(
              state, b, config.drift_loss_weight, config.num_frames,
              config.final_step_only),
          stream))
  path_launches['perception_training'] = counted
  print(f'20b: {time.perf_counter() - t0:.1f} s; the trainers launched '
        f'{counted}', flush=True)
  for kernel in ('noise_chain', 'clahe_hist_lut', 'clahe_remap',
                 'clahe_small'):
    check(counted.get(kernel, 0) > 0, f'20: the trainers launched no {kernel}')

  # -- 20c. the graph aligner ------------------------------------------------------
  t0 = time.perf_counter()
  model = graph_model.from_flax(
      serialization.read_params_msgpack(graph_model.SHIPPED_DIR)).to(dev)
  evals = graph_data.dataset_iterator(PERCEPTION_EVAL_SEED, batch_size=16,
                                      device=dev)
  errs, zeros = [], []
  with torch.no_grad():
    for _ in range(PERCEPTION_EVAL_BATCHES):
      batch = next(evals)
      g, _ = graph_model.batched_apply(model, batch)
      errs.append(torch.linalg.vector_norm(g - batch['drift'], dim=-1).mean())
      zeros.append(torch.linalg.vector_norm(batch['drift'], dim=-1).mean())
  err_shipped = float(torch.stack(errs).mean())
  err_zero = float(torch.stack(zeros).mean())
  print(f'20c shipped graph_aligner (width 64, 3 layers, k 8, capacity 256, '
        f'2 frames) on {PERCEPTION_EVAL_BATCHES} fixed batches of 16: drift '
        f'error {err_shipped:.4f} A; the zero predictor {err_zero:.4f} A',
        flush=True)
  check(err_shipped < err_zero,
        '20c: the shipped graph aligner does not beat the zero predictor')
  config = graph_train.Config(workdir=os.path.join(tmp, 'graph'), epochs=3,
                              steps_per_epoch=20, eval_steps=4)
  history = []
  t1 = time.perf_counter()
  state = graph_train.train(config, device=dev,
                            progress=lambda e, m: history.append(m))
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t1
  print(f'20c fresh graph trainer (Config defaults, 3 x 20 steps, 4 eval '
        f'steps): {train_s:.2f} s; {json.dumps(history)}', flush=True)
  check(np.isfinite(history[-1]['drift_error'])
        and history[-1]['drift_error'] < GRAPH_TRAIN_BAR,
        '20c: the graph trainer is above its drift-error bar')
  stream = graph_data.dataset_iterator(7, batch_size=16, device=dev)
  out['graph'] = dict(
      shipped_drift_error=err_shipped, zero_drift_error=err_zero,
      trained_drift_error=history[-1]['drift_error'], train_seconds=train_s,
      **_time_train_step('graph aligner (16 graphs of 2 x 256 nodes)', smi,
                         state, lambda b: graph_train.train_step(state, b),
                         stream))
  print(f'20c: {time.perf_counter() - t0:.1f} s', flush=True)

  # -- 20d. the train CLI and save_model ------------------------------------------
  t0 = time.perf_counter()
  work, art = os.path.join(tmp, 'cli'), os.path.join(tmp, 'cli_artifact')
  env = dict(os.environ, PYTHONPATH=ROOT)
  commands = (
      ['-m', 'putting_dune_torch.atom_detection.train', f'--workdir={work}',
       '--epochs=1', '--steps_per_epoch=2', '--eval_steps=1',
       '--batch_size=16', '--image_size=128', '--noisy_images'],
      ['-m', 'putting_dune_torch.atom_detection.save_model',
       f'--workdir={work}', f'--output_dir={art}', '--image_size=128'])
  for argv in commands:
    run = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    print(f'20d {" ".join(argv[1:3])}: rc {run.returncode}; '
          f'{run.stdout.strip()[-300:]}', flush=True)
    check(run.returncode == 0, f'20d: {argv[1]} failed: {run.stderr[-2000:]}')
  with open(os.path.join(art, 'model.json')) as f:
    meta = json.load(f)
  check(sorted(meta) == ['features', 'image_size', 'kind', 'num_classes']
        and os.path.exists(os.path.join(art, 'params.msgpack')),
        '20d: save_model wrote no artifact')
  print(f'20d: {time.perf_counter() - t0:.1f} s; model.json {meta}',
        flush=True)
  return out


def _hold_trainer_kernels(dev, recorded) -> dict:
  """Phase 20e: each kernel the trainers launched against its twin on the
  inputs the trainers gave it."""
  import torch

  gen = torch.Generator(device=dev).manual_seed(20)
  errs = {}
  for shape in ((32, 256, 256), (32, 128, 128)):
    errs[f'noise_chain {shape}'] = _hold_noise_chain(
        dev, _recorded(recorded, 'noise_chain', shape, '20e'),
        "20e on a trainer's clean frames:", gen)
  errs['clahe_pair (32, 256, 256)'] = _hold_clahe_pair(
      _recorded(recorded, 'clahe_hist_lut', (32, 256, 256), '20e'),
      "20e clahe_hist_lut + clahe_remap on the detector's frames")
  render = _recorded(recorded, 'clahe_small', (32, 128, 128), '20e')
  kw = {k: render[k] for k in ('clip_limit', 'grid_size', 'nbins')}
  errs['clahe_small (32, 128, 128)'] = _hold_clahe_small(
      render['image'], kw, "20e clahe_small (32, 128, 128) on the aligner's "
      'frames')
  return errs


# Phase 21 records the phase 19c rehearsal (`greedy_on_neighbor`, 0.5 A a
# frame per axis, 128^2 renders) for PIPELINE_EPISODES episodes of
# REHEARSAL_STEPS steps: a few microscope sessions' worth of frames. 21b
# aligns all of them and holds the first PIPELINE_ALIGNED to do_alignment
# in memory; 21c trains the rate learner on the aligned file at the shipped
# widths (train_rate_learner's defaults: 100 models, hidden (128, 128),
# batch 256, bootstrap), with the epochs cut from 500 to
# PIPELINE_RATE_EPOCHS, then distils it as the CLI does, with the epochs
# cut from 10,000 to PIPELINE_DISTILL_EPOCHS (batch 4096, 10 batches an
# epoch, as phase 17).
PIPELINE_EPISODES = 32
PIPELINE_ALIGNED = 8
PIPELINE_RATE_EPOCHS = 10
PIPELINE_DISTILL_EPOCHS = 20
# 21d: the detector's record dataset, 256^2 noisy scenes, 2 shards of 64,
# and 4 train steps from it at the shipped widths, batch 32.
PIPELINE_DETECTOR_EXAMPLES = 128


def data_pipeline(dev, smi, path_launches, synthetic_detector,
                  keep_aligned=None) -> dict:
  """Phase 21 (see the module docstring); returns the numbers it read. Its
  files are a temporary directory, removed after; the aligned file is
  copied to `keep_aligned` when given (phase 22c reads it)."""
  import shutil
  import tempfile

  recorded = {}
  with tempfile.TemporaryDirectory(prefix='smoke_pipeline_') as tmp:
    with _recording_inputs(recorded):
      out = _data_pipeline(dev, smi, path_launches, synthetic_detector, tmp)
    if keep_aligned:
      shutil.copy(os.path.join(tmp, 'aligned.riegeli'), keep_aligned)
  out['twins'] = _hold_pipeline_kernels(dev, recorded)
  return out


def _mb_s(nbytes: int, seconds: float) -> float:
  return nbytes / 1e6 / seconds


def _data_pipeline(dev, smi, path_launches, synthetic_detector, tmp) -> dict:
  import numpy as np
  import torch

  from putting_dune_torch import microscope_agent
  from putting_dune_torch import microscope_data as md
  from putting_dune_torch import registry
  from putting_dune_torch.agents import planner as planner_lib
  from putting_dune_torch.agents import vision_planner
  from putting_dune_torch.atom_detection import data as det_data
  from putting_dune_torch.atom_detection import train as det_train
  from putting_dune_torch.image_alignment import inference as alignment
  from putting_dune_torch.io import records
  from putting_dune_torch.io import riegeli_native
  from putting_dune_torch.ops import _build
  from putting_dune_torch.pipeline import align_trajectories
  from putting_dune_torch.pipeline import train_rate_learner
  from putting_dune_torch.pipeline import trajectories_to_transitions
  from putting_dune_torch.proto import wire
  from putting_dune_torch.rate_learning import config as rate_config
  from putting_dune_torch.rate_learning import data_utils
  from putting_dune_torch.rate_learning import predictor as predictor_lib

  out = {}
  _build.reset_launches()

  # -- 21a. record the rehearsal; TFRecord and riegeli, back and forth -------
  t0 = time.perf_counter()
  experiment = registry.create_microscope_experiment('greedy_on_neighbor')
  rng = np.random.default_rng(21)
  logdir = os.path.join(tmp, 'logs')
  logger = microscope_agent.MicroscopeAgentLogger(
      microscope_agent.MicroscopeAgent(rng, experiment, device=dev),
      logdir=logdir)
  for seed in range(PIPELINE_EPISODES):
    mic = microscope_agent.SimulatedMicroscope(
        seed=seed, drift_per_frame_angstroms=0.5, image_size=128, device=dev)
    microscope_agent.rehearse(mic, logger, np.random.default_rng(seed), None,
                              steps=REHEARSAL_STEPS)
  torch.cuda.synchronize()
  record_s = time.perf_counter() - t0
  t1 = time.perf_counter()
  logger.flush()
  flush_s = time.perf_counter() - t1
  trajectories = logger.trajectories
  observations = [o for t in trajectories for o in t.observations]
  frames = len(observations)
  check(len(trajectories) == PIPELINE_EPISODES
        and frames == PIPELINE_EPISODES * REHEARSAL_STEPS,
        f'21a: recorded {len(trajectories)} episodes, {frames} frames')
  t1 = time.perf_counter()
  payloads = [t.to_proto_bytes() for t in trajectories]
  encode_us = 1e6 * (time.perf_counter() - t1) / frames
  nbytes = sum(map(len, payloads))
  t1 = time.perf_counter()
  decoded = [md.Trajectory.from_proto_bytes(p) for p in payloads]
  decode_us = 1e6 * (time.perf_counter() - t1) / frames
  image_bytes = observations[0].image.nbytes
  print(f'21a recorded {PIPELINE_EPISODES} episodes x {REHEARSAL_STEPS} steps '
        f'({frames} frames of {observations[0].image.shape} '
        f'{observations[0].image.dtype}, {image_bytes} bytes an image) in '
        f'{record_s:.2f} s; the logger wrote trajectories.tfrecords and the '
        f'CSVs in {flush_s:.2f} s; {nbytes} bytes of records', flush=True)
  tf_path = os.path.join(logdir, 'trajectories.tfrecords')
  check(records.read_tfrecords(tf_path) == payloads,
        '21a: the logger\'s TFRecord file differs from the trajectories')
  for got, want in zip(decoded, trajectories):
    check(len(got.observations) == len(want.observations),
          '21a: a decoded trajectory lost observations')
    for a, b in zip(got.observations, want.observations):
      check(np.array_equal(a.image, b.image) and a.grid == b.grid
            and [c.dwell_time for c in a.controls]
            == [c.dwell_time for c in b.controls],
            '21a: a decoded observation differs from the recorded one')
      check(np.allclose(a.fov.lower_left, b.fov.lower_left, rtol=0,
                        atol=1e-5 * max(1.0, np.abs(b.fov.lower_left).max())),
            '21a: a decoded FOV differs beyond float32 rounding')
  check(all(d.to_proto_bytes() == p for d, p in zip(decoded, payloads)),
        '21a: re-encoding a decoded trajectory changes its bytes')
  codecs = riegeli_native.available_codecs()
  io = {}
  paths = {'tfrecords': os.path.join(tmp, 'trajectories.tfrecords')}
  for codec in ['tfrecords'] + codecs:
    path = paths.setdefault(codec, os.path.join(tmp, f'{codec}.riegeli'))
    t1 = time.perf_counter()
    if codec == 'tfrecords':
      records.write_records(path, payloads)
    else:
      riegeli_native.write_riegeli_records(path, payloads, compression=codec)
    write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    back = records.read_records(path)
    read_s = time.perf_counter() - t1
    check(back == payloads, f'21a: {codec} payloads differ after the trip')
    io[codec] = dict(write_mb_s=_mb_s(nbytes, write_s),
                     read_mb_s=_mb_s(nbytes, read_s),
                     file_mb=os.path.getsize(path) / 1e6)
  check(records.read_records(paths['tfrecords'], md.Trajectory)[0]
        .to_proto_bytes() == payloads[0], '21a: TFRecord decode differs')
  print(f'21a the card\'s machine has the riegeli codecs {codecs}; '
        f'TFRecord and riegeli with each read back equal to what was '
        f'written; decoded trajectories equal the recorded ones', flush=True)
  # -- 21e. throughput on the host --------------------------------------------
  for codec, row in io.items():
    print(f"21e {codec}: write {row['write_mb_s']:.1f} MB/s, read "
          f"{row['read_mb_s']:.1f} MB/s of {nbytes / 1e6:.2f} MB of records "
          f"({row['file_mb']:.2f} MB on disk); host of {smi}", flush=True)
  print(f'21e wire codec: {encode_us:.1f} us an observation to encode, '
        f'{decode_us:.1f} us to decode ({frames} observations of '
        f'{nbytes / frames / 1e3:.1f} kB); host of {smi}', flush=True)
  # The atomic grids alone: their numpy pass against the codec's object an
  # atom, on the same observations.
  grids = [o.grid for o in observations]
  t1 = time.perf_counter()
  grid_bytes = [g.to_proto_bytes() for g in grids]
  grid_encode_us = 1e6 * (time.perf_counter() - t1) / frames
  t1 = time.perf_counter()
  generic_bytes = [g.to_proto().SerializeToString() for g in grids]
  generic_encode_us = 1e6 * (time.perf_counter() - t1) / frames
  check(generic_bytes == grid_bytes,
        '21e: the grid fast path\'s bytes differ from the codec\'s')
  t1 = time.perf_counter()
  for b in grid_bytes:
    md.AtomicGrid.from_proto_bytes(b)
  grid_decode_us = 1e6 * (time.perf_counter() - t1) / frames
  t1 = time.perf_counter()
  for b in grid_bytes:
    md.AtomicGrid.from_proto(wire.AtomicGrid.FromString(b))
  generic_decode_us = 1e6 * (time.perf_counter() - t1) / frames
  atoms = np.mean([g.num_atoms for g in grids])
  print(f'21e atomic grids ({atoms:.0f} atoms on average): encode '
        f'{grid_encode_us:.1f} us an observation by the numpy pass, '
        f'{generic_encode_us:.1f} us by an object an atom; decode '
        f'{grid_decode_us:.1f} / {generic_decode_us:.1f} us; host of {smi}',
        flush=True)
  out['record'] = dict(episodes=PIPELINE_EPISODES, frames=frames,
                       record_bytes=nbytes, record_s=record_s,
                       codecs=codecs, io=io, encode_us_per_obs=encode_us,
                       decode_us_per_obs=decode_us,
                       grid_us_per_obs=dict(
                           encode=grid_encode_us,
                           encode_per_atom=generic_encode_us,
                           decode=grid_decode_us,
                           decode_per_atom=generic_decode_us))

  # -- 21b. align_trajectories on the logger's file, as a subprocess ---------
  t0 = time.perf_counter()
  align_out = os.path.join(tmp, 'aligned.riegeli')
  env = dict(os.environ, PYTHONPATH=ROOT)
  argv = [sys.executable, '-m', 'putting_dune_torch.pipeline.'
          'align_trajectories', f'--source_path={tf_path}',
          f'--target_path={align_out}',
          f'--aligner_workdir={alignment.SHIPPED_ALIGNER_DIR}']
  run = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
  cli_s = time.perf_counter() - t0
  print(f'21b align_trajectories CLI on {PIPELINE_EPISODES} trajectories: rc '
        f'{run.returncode} in {cli_s:.2f} s; {run.stdout.strip()[-200:]}',
        flush=True)
  check(run.returncode == 0, f'21b: align_trajectories failed: '
        f'{run.stderr[-2000:]}')
  aligner = alignment.ImageAligner.from_checkpoint(device=dev)
  args = align_trajectories.Args(
      source_path=tf_path, target_path=align_out,
      aligner_workdir=alignment.SHIPPED_ALIGNER_DIR)
  t1 = time.perf_counter()
  in_memory = [align_trajectories.do_alignment(t, args, aligner)
               for t in trajectories[:PIPELINE_ALIGNED]]
  memory_s = time.perf_counter() - t1
  from_cli = records.read_records(align_out, md.Trajectory)
  check(len(from_cli) == PIPELINE_EPISODES
        and all(len(t.observations) == REHEARSAL_STEPS for t in from_cli),
        '21b: aligned trajectories lost')
  fov_err = 0.0
  for got, want in zip(from_cli, in_memory):
    for a, b in zip(got.observations, want.observations):
      # The file holds the FOVs as float32.
      fov_err = max(fov_err, float(np.abs(np.concatenate([
          a.fov.lower_left - b.fov.lower_left,
          a.fov.upper_right - b.fov.upper_right])).max()))
  shift = float(np.mean([np.linalg.norm(
      t.observations[-1].fov.lower_left - r.observations[-1].fov.lower_left)
      for t, r in zip(in_memory, trajectories)]))
  print(f'21b the CLI\'s file against do_alignment in memory '
        f'(the first {PIPELINE_ALIGNED}, {memory_s:.2f} s for '
        f'{PIPELINE_ALIGNED * REHEARSAL_STEPS} frames): '
        f'FOVs max|d| {fov_err:.3g} A (bar {ALIGNMENT_FOV_TOL}); mean '
        f'correction of the last frame {shift:.3f} A', flush=True)
  check(fov_err <= ALIGNMENT_FOV_TOL,
        '21b: the aligned file differs from do_alignment in memory')
  out['align'] = dict(cli_s=cli_s, memory_s=memory_s, fov_err=fov_err,
                      last_frame_correction=shift)

  # -- 21c. transitions, then the rate learner at the shipped widths ----------
  t0 = time.perf_counter()
  transitions_path = os.path.join(tmp, 'transitions.riegeli')
  n_transitions = trajectories_to_transitions.main([
      f'--source_path={align_out}', f'--target_path={transitions_path}',
      '--previous_controls_at_current_timestep'])
  t2t_s = time.perf_counter() - t0
  check(n_transitions == PIPELINE_EPISODES * (REHEARSAL_STEPS - 1)
        and len(records.read_records(transitions_path)) == n_transitions,
        '21c: transitions miscounted')
  workdir = os.path.join(tmp, 'rates')
  rate_args = train_rate_learner._parse_args([
      f'--source_path={align_out}', f'--workdir={workdir}',
      f'--epochs={PIPELINE_RATE_EPOCHS}',
      f'--epoch_chunk={PIPELINE_RATE_EPOCHS}', '--nodistill',
      '--noplot_metrics', '--novisualize_rates',
      '--previous_controls_at_current_timestep'])
  check((rate_args.num_models, rate_args.hidden_dimensions,
         rate_args.batch_size, rate_args.bootstrap) ==
        (100, (128, 128), 256, True), '21c: not the shipped widths')
  t1 = time.perf_counter()
  stacked, counts, predictor = train_rate_learner.main(rate_args)
  # The CLI's distillation, with its epochs cut (PIPELINE_DISTILL_EPOCHS).
  predictor.distill(
      data_utils.augment_data(**{
          k: torch.as_tensor(stacked[k], device=dev)
          for k in ('next_state', 'dt', 'rates', 'position', 'context')}),
      rate_config.DistillConfig(epochs=PIPELINE_DISTILL_EPOCHS))
  predictor.save(workdir)
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t1
  metrics = np.load(os.path.join(workdir, 'metrics.npz'))
  loss = metrics['train_loss']
  first, last = float(loss[:, 0].mean()), float(loss[:, -1].mean())
  print(f'21c trajectories_to_transitions: {n_transitions} transitions in '
        f'{t2t_s:.2f} s; train_rate_learner (100 models, hidden (128, 128), '
        f'batch 256, bootstrap; epochs 500 -> {PIPELINE_RATE_EPOCHS}, '
        f'distillation epochs 10000 -> {PIPELINE_DISTILL_EPOCHS}) in '
        f'{train_s:.2f} s on {len(stacked["dt"])} datapoints; drop reasons '
        f'{json.dumps(counts)}; mean loss ({loss.shape[0]} models) first '
        f'epoch {first:.4f}, last {last:.4f}; metrics {metrics.files}',
        flush=True)
  check(counts['kept'] > 0 and np.isfinite(loss).all(),
        '21c: no datapoints kept or the loss is not finite')
  check(predictor.num_models == 1, '21c: the predictor was not distilled')
  saved = predictor_lib.LearnedRatePredictor(device=dev)
  saved.load(workdir)
  # The rehearsal's controls carry no voltage or current, which stack_data
  # reads as 0: the model knows that context only.
  planner = planner_lib.PlannerAgent(
      rate_fn=saved.as_rate_function(voltage_kv=0.0, current_na=0.0),
      dwell_seconds=1.5, device=dev)
  gen = torch.Generator(device=dev).manual_seed(21)
  angles = torch.tensor([90.0, 210.0, 330.0], device=dev) * np.pi / 180
  neighbors = 1.42 * torch.stack([torch.cos(angles), torch.sin(angles)], -1)
  si = torch.rand((4096, 2), generator=gen, device=dev) * 10.0
  beam = si + (torch.rand((4096, 2), generator=gen, device=dev) - 0.5) * 6.0
  rates = planner.rate_fn(si, si[:, None, :] + neighbors, beam)
  check(bool(torch.isfinite(rates).all()) and bool((rates > 0).all()),
        '21c: the learned planner\'s rates are not finite and positive')
  print(f'21c the saved predictor as the planner\'s rate function (0 kV, '
        f'0 nA) on 4096 beams within 3 A of a silicon: rates finite and '
        f'positive, in '
        f'[{float(rates.min()):.4g}, {float(rates.max()):.4g}] per s',
        flush=True)
  out['rates'] = dict(transitions=n_transitions, counts=counts,
                      datapoints=int(len(stacked['dt'])), train_s=train_s,
                      loss_first=first, loss_last=last,
                      rate_min=float(rates.min()), rate_max=float(rates.max()))

  # -- 21d. the detector's record dataset and the trainer from it -------------
  t0 = time.perf_counter()
  det_dir = os.path.join(tmp, 'detector_records')
  written = det_data.write_dataset(
      det_dir, num_examples=PIPELINE_DETECTOR_EXAMPLES, seed=21,
      gen_batch_size=64, image_size=256, noisy=True, examples_per_shard=64,
      device=dev)
  write_s = time.perf_counter() - t0
  shards = sorted(os.listdir(det_dir))
  check(written == PIPELINE_DETECTOR_EXAMPLES and len(shards) == 2,
        f'21d: wrote {written} examples in {shards}')
  shipped_dir = vision_planner.SHIPPED_DETECTOR_DIR
  config = det_train.Config(
      workdir=os.path.join(tmp, 'det'), image_size=256, batch_size=32,
      epochs=1, steps_per_epoch=4, eval_steps=1, noisy_images=True,
      features=tuple(det_train.load_arch(shipped_dir)['features']),
      data_source=f'records:{det_dir}', seed=21)
  history = []
  t1 = time.perf_counter()
  state = det_train.train(config, device=dev,
                          progress=lambda e, m: history.append(m))
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t1
  check(len(history) == 1 and np.isfinite(history[0]['loss']),
        '21d: the detector trained from records has no finite loss')
  stream = det_data.records_dataset_iterator(det_dir, 1, batch_size=32,
                                             device=dev)
  batch = next(stream)
  data_ms = time_ms(lambda: next(stream), repeats=8, warmup=1)
  step_ms = time_ms(lambda: det_train.train_step(state, batch),
                    repeats=10, warmup=2)
  print(f'21d write_dataset: {written} noisy 256^2 scenes in {len(shards)} '
        f'shards in {write_s:.2f} s; atom_detection.train '
        f'--data_source=records:<dir> (features {config.features}, batch 32, '
        f'4 steps, 1 eval step) in {train_s:.2f} s, {json.dumps(history)}; '
        f'a train step {step_ms:.3f} ms, a data step from records '
        f'{data_ms:.3f} ms (phase 20 synthetic: train step '
        f"{synthetic_detector.get('step_ms', float('nan')):.3f} ms, data step "
        f"{synthetic_detector.get('data_ms', float('nan')):.3f} ms); on {smi}",
        flush=True)
  out['detector'] = dict(examples=written, write_s=write_s, train_s=train_s,
                         step_ms=step_ms, data_ms=data_ms, history=history)
  counted = dict(_build.LAUNCHES)
  path_launches['data_pipeline'] = counted
  print(f'21: the data pipeline launched {counted}', flush=True)
  for kernel in ('noise_chain', 'clahe_small', 'clahe_hist_lut',
                 'clahe_remap'):
    check(counted.get(kernel, 0) > 0, f'21: the pipeline launched no {kernel}')
  return out


# Phase 22 records VIDEO_ENVS episode videos of `ppo_simple_images_tf`
# (512^2 render) from the first of VIDEO_SEEDS seeds, and one from the host
# evaluator; times RASTER_REPEATS frames; runs the rate-learner CLI with its
# plot flags on phase 21's aligned file (epochs cut as 21c, distillation
# off: the CLI distils for 10,000 epochs); then the mesh at world 1: the
# train CLI at phase 18b's pixel PPO configuration (128^2 render, batch
# 256, rollout 16, shaping 0.05) for MESH_PPO_UPDATES updates with and
# without --mesh=data:1, the eval CLI with and without it, and the rate
# learner's model axis.
VIDEO_SEEDS = 8
VIDEO_ENVS = 4
RASTER_REPEATS = 20
MESH_PPO_UPDATES = 2


def _sync(dev) -> None:
  import torch

  if dev.type == 'cuda':
    torch.cuda.synchronize(dev)


def plots_and_mesh(dev, smi, path_launches, aligned_path) -> dict:
  """Phase 22 (see the module docstring); returns the numbers it read. Its
  files are a temporary directory, removed after."""
  import tempfile

  recorded = {}
  with tempfile.TemporaryDirectory(prefix='smoke_plots_') as tmp:
    with _recording_inputs(recorded):
      out = _plots_and_mesh(dev, smi, path_launches, aligned_path, tmp)
  out['twins'] = _hold_phase22_kernels(dev, recorded)
  return out


def _same_results(a, b) -> bool:
  import dataclasses
  import math

  def key(r):
    return tuple('nan' if isinstance(v, float) and math.isnan(v) else v
                 for v in dataclasses.astuple(r))

  return [key(r) for r in a] == [key(r) for r in b]


def _plots_and_mesh(dev, smi, path_launches, aligned_path, tmp) -> dict:
  import numpy as np
  import torch

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import eval_lib
  from putting_dune_torch import plotting_utils
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.agents import ppo
  from putting_dune_torch.agents import train_ppo
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.io import gif
  from putting_dune_torch.io import png
  from putting_dune_torch.ops import _build
  from putting_dune_torch.parallel import mesh as mesh_lib
  from putting_dune_torch.rate_learning import config as rate_config
  from putting_dune_torch.rate_learning import data_utils
  from putting_dune_torch.rate_learning import train as rate_train

  out = {}
  device_flag = [] if dev.type == 'cuda' else ['--device=cpu']

  # -- 22a. videos from the pixel eval -----------------------------------------
  name = 'ppo_simple_images_tf'
  experiment = registry.create_eval_experiment(name)
  seeds = list(range(VIDEO_SEEDS))

  def video_env():
    return run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=len(seeds), device=dev)

  policy = eval_cli.policy_for_agent(
      experiment.get_policy(experiment.get_adapters_and_goal(), dev))
  plain = eval_lib.evaluate_batched(video_env(), policy, seeds)
  video_dir = os.path.join(tmp, 'videos')
  env = video_env()
  _build.reset_launches()
  _sync(dev)
  t0 = time.perf_counter()
  taped = eval_lib.evaluate_batched(env, policy, seeds,
                                    video_save_dir=video_dir,
                                    video_envs=VIDEO_ENVS)
  _sync(dev)
  seconds = time.perf_counter() - t0
  counted = dict(_build.LAUNCHES)
  path_launches['video_eval_512'] = counted
  check(_same_results(plain, taped),
        '22a: the run with videos differs from the run without')
  for kernel in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
    check(counted[kernel] > 0, f'22a: {kernel} was not launched')
  # Frame 0 again, from a reset on the evaluator's stream.
  state, _ = env.reset(env_lib.make_generator(eval_lib.suite_seed(seeds),
                                              dev))
  pose = [x.cpu().numpy()[None] for x in eval_lib.video_pose(state,
                                                             VIDEO_ENVS)]
  first = dict(zip(('si', 'offset', 'theta', 'goal'), pose))
  written, frames = 0, 0
  for i, result in enumerate(taped[:VIDEO_ENVS]):
    path = os.path.join(video_dir, f'{result.seed}.gif')
    with open(path, 'rb') as f:
      data = f.read()
    written += len(data)
    video = gif.decode(data, limit=1)
    frames += video.count
    check(video.count == result.num_actions_taken + 1,
          f'22a: {path} holds {video.count} frames, '
          f'{result.num_actions_taken + 1} expected')
    positions, numbers, goal = eval_lib.video_scenes(env.lattice, first, i, 1)
    want = plotting_utils.generate_video_from_trajectory(
        positions, numbers, goal_position=goal).frames[0]
    check(np.array_equal(video.frames[0], want),
          f'22a: {path} frame 0 differs from the raster frame')
  palette = plotting_utils.raster.Palette()
  t0 = time.perf_counter()
  for _ in range(RASTER_REPEATS):
    index = plotting_utils.episode_frame(positions[0], numbers[0], palette, 0,
                                         goal)
  raster_ms = 1e3 * (time.perf_counter() - t0) / RASTER_REPEATS
  t0 = time.perf_counter()
  for _ in range(RASTER_REPEATS):
    gif.lzw_encode(index, 8)
  encode_ms = 1e3 * (time.perf_counter() - t0) / RASTER_REPEATS
  print(f'22a {name} at 512^2, {VIDEO_SEEDS} seeds with {VIDEO_ENVS} '
        f'videos: {seconds:.2f} s, results equal to the run without videos; '
        f'{frames} frames, {written / 1e6:.3f} MB written; a frame '
        f'{raster_ms:.3f} ms to rasterise ({len(positions[0])} atoms, 500 x '
        f'500) and {encode_ms:.3f} ms to LZW-encode, on the host; frame 0 of '
        f'each GIF bit-equal to the raster frame; launches {counted}',
        flush=True)
  out['videos'] = dict(seconds=seconds, frames=frames, mb=written / 1e6,
                       raster_ms=raster_ms, encode_ms=encode_ms,
                       launches=counted)

  host_env = run_helpers.create_putting_dune_env(
      0, experiment.get_adapters_and_goal, experiment.get_simulator_config,
      device=dev)
  agent = registry.host_agent(experiment, np.random.default_rng(0),
                              experiment.get_adapters_and_goal(), dev)
  host_dir = os.path.join(tmp, 'host')
  (result,) = eval_lib.evaluate(agent, host_env, [0],
                                video_save_dir=host_dir)
  with open(os.path.join(host_dir, '0.gif'), 'rb') as f:
    host_video = gif.decode(f.read(), limit=1)
  print(f'22a host evaluator, seed 0: {result.num_actions_taken} actions, '
        f'{host_video.count} frames', flush=True)
  check(host_video.count == result.num_actions_taken + 1,
        '22a: the host evaluator\'s GIF misses frames')

  # -- 22b. render() -------------------------------------------------------------
  image = host_env.render()
  print(f'22b DmEnvWrapper.render(): {image.shape} {image.dtype}, '
        f'{len(np.unique(image.reshape(-1, 3), axis=0))} colours', flush=True)
  check(image.shape == (500, 500, 3) and image.dtype == np.uint8
        and float(image.std()) > 0, '22b: render() is blank or misshapen')
  del env, host_env, agent
  torch.cuda.empty_cache()

  # -- 22c. the rate-learner CLI with its plot flags ----------------------------
  workdir = os.path.join(tmp, 'rates')
  t0 = time.perf_counter()
  run = subprocess.run(
      [sys.executable, '-m', 'putting_dune_torch.pipeline.train_rate_learner',
       f'--source_path={aligned_path}', f'--workdir={workdir}',
       f'--epochs={PIPELINE_RATE_EPOCHS}',
       f'--epoch_chunk={PIPELINE_RATE_EPOCHS}', '--nodistill',
       '--previous_controls_at_current_timestep', *device_flag],
      cwd=ROOT, capture_output=True, text=True, timeout=600)
  cli_s = time.perf_counter() - t0
  check(run.returncode == 0, '22c: train_rate_learner failed:\n'
        + run.stdout[-2000:] + run.stderr[-2000:])
  pngs = sorted(f for f in os.listdir(workdir) if f.endswith('.png'))
  shapes = {}
  for f in pngs:
    with open(os.path.join(workdir, f), 'rb') as fh:
      img = png.imdecode(fh.read())
    shapes[f] = list(img.shape)
    check(float(img.std()) > 0, f'22c: {f} is blank')
  want = sorted([f'{k}.png' for k in rate_train.METRIC_NAMES]
                + ['avg_context_rates.png'])
  print(f'22c train_rate_learner CLI (100 models, epochs '
        f'{PIPELINE_RATE_EPOCHS}, --nodistill, plot flags on) in '
        f'{cli_s:.2f} s: {shapes}', flush=True)
  check(pngs == want and os.path.exists(os.path.join(workdir, 'metrics.npz')),
        f'22c: wrote {pngs}, expected {want} and metrics.npz')
  out['rate_cli'] = dict(seconds=cli_s, pngs=shapes)

  # -- 22d. the mesh at world 1 -------------------------------------------------
  ppo_argv = ['--train_experiment=relative_simple_rates_from_images',
              '--batch_size=256', f'--num_updates={MESH_PPO_UPDATES}',
              '--rollout_length=16', '--reward_shaping=0.05',
              '--render_size=128', '--eval_suite=', *device_flag]
  plain_dir, mesh_dir = os.path.join(tmp, 'ppo'), os.path.join(tmp, 'mesh')
  # cuDNN's default backward algorithms sum in no fixed order, so two
  # unsharded runs differ too; with cuDNN's deterministic ones (and every
  # other op as by default) they agree (scripts/ppo_determinism.py).
  torch.backends.cudnn.deterministic = True
  try:
    train_ppo.main(ppo_argv + [f'--workdir={plain_dir}'])
    _build.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    train_ppo.main(ppo_argv + [f'--workdir={mesh_dir}', '--mesh=data:1'])
    _sync(dev)
    mesh_s = time.perf_counter() - t0
  finally:
    torch.backends.cudnn.deterministic = False
  counted = dict(_build.LAUNCHES)
  path_launches['mesh_ppo_128'] = counted
  steps = MESH_PPO_UPDATES * 16
  check(counted['noise_chain'] == steps + 1
        and counted['clahe_small'] == steps + 1,
        '22d: noise_chain and clahe_small not once a step and reset')
  params = [eval_agent.read_flax_params(os.path.join(d, 'policy',
                                                     'policy.ckpt'))
            for d in (plain_dir, mesh_dir)]
  ppo_diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                 for a, b in zip(_leaves(params[0]), _leaves(params[1])))
  print(f'22d train_ppo --mesh=data:1 (nccl over a localhost TCP store), '
        f'{MESH_PPO_UPDATES} pixel PPO updates at 128^2 in {mesh_s:.2f} s '
        f'(cuDNN\'s deterministic algorithms, both runs): params max|d| '
        f'{ppo_diff:.3g} against --mesh=\'\' (bar 1e-6); '
        f'launches {counted}', flush=True)
  check(ppo_diff <= 1e-6, '22d: the world-1 mesh PPO params differ')

  eval_argv = ['--experiment_name=greedy_simple_rates', *device_flag]
  unsharded = eval_cli.main(eval_cli._parse_args(eval_argv))['results']
  sharded = eval_cli.main(eval_cli._parse_args(eval_argv + ['--mesh=data:1'])
                          )['results']
  print(f'22d eval --mesh=data:1 greedy_simple_rates tiny_eval: per-seed '
        f'results equal to the unsharded run: '
        f'{_same_results(sharded, unsharded)}', flush=True)
  check(_same_results(sharded, unsharded),
        '22d: the world-1 mesh eval differs from the unsharded run')

  with contextlib.ExitStack() as stack:
    mesh_lib.initialize_distributed(f'localhost:{mesh_lib.free_port()}', 1, 0,
                                    device=dev)
    stack.callback(mesh_lib.shutdown)
    data, _ = data_utils.generate_synthetic_data(num_data=4096, device=dev)
    data = {k: v.cpu().numpy() for k, v in data.items()}
    config = rate_config.RateLearningConfig(batch_size=256, epochs=3,
                                            num_models=8)
    train_sets, test_sets = rate_train.create_dataset_splits(data, 8, seed=0)
    ensembles = []
    for mesh in (None, mesh_lib.make_mesh([1], ('model',), device=dev)):
      model, _, _ = rate_train.train_multiple_models(
          train_sets, test_sets,
          torch.Generator(device=dev).manual_seed(0), 8, config, device=dev,
          mesh=mesh)
      ensembles.append(model.state_dict())
    rate_diff = max(float((ensembles[0][k] - ensembles[1][k]).abs().max())
                    for k in ensembles[0])
    dry = ppo.dryrun_mesh_training_step(mesh_lib.make_mesh(device=dev))
    print(f'22d rate learner model axis at world 1 (8 models, 3 epochs): '
          f'max|d| {rate_diff:.3g} against the plain ensemble; PPO dry run '
          f'loss {dry["loss"]:.4f}, spread {dry["spread"]}', flush=True)
    check(rate_diff <= 1e-6, '22d: the model axis differs at world 1')

    # The all-reduces' cost at world 1: one more update of the 18b config
    # with and without the process group.
    exp = registry.create_train_experiment(
        'relative_simple_rates_from_images')
    ppo_env = run_helpers.create_batched_env(
        exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=256,
        image_size=128, device=dev)
    config = ppo.PPOConfig(num_updates=1, rollout_length=16,
                           reward_shaping_coef=0.05)
    timings = {}
    for label, mesh in (('without', None),
                        ('with', mesh_lib.make_mesh(device=dev))):
      trainer = ppo.PPOTrainer(ppo_env, config, mesh)
      carry = trainer.init_carry(0)
      time_update(trainer, carry)
      timings[label] = time_update(trainer, carry)
    print(f'22d one PPO update at 128^2 (batch 256): without the process '
          f'group {timings["without"][0]:.4f} ms a rollout step, '
          f'{timings["without"][1]:.4f} ms a gradient step; with it '
          f'{timings["with"][0]:.4f} ms, {timings["with"][1]:.4f} ms (the '
          f'gradient and metric all-reduces, on {smi})', flush=True)
  try:
    train_ppo.main(ppo_argv + [f'--workdir={tmp}/refused', '--mesh=data:2'])
    refused = ''
  except ValueError as e:
    refused = str(e)
  print(f'22d --mesh=data:2 on one card: {refused!r}', flush=True)
  check('wants 2 devices' in refused,
        '22d: --mesh=data:2 was not refused on one card')
  out['mesh'] = dict(ppo_diff=ppo_diff, rate_diff=rate_diff, seconds=mesh_s,
                     launches=counted, update_ms=timings)
  return out


def _hold_phase22_kernels(dev, recorded) -> dict:
  """Phase 22e: max|d| of each kernel against its twin on the frames the
  video eval (512^2) and the mesh PPO run (128^2) gave it."""
  import torch

  gen = torch.Generator(device=dev).manual_seed(22)
  errs = {}
  for size, batch in ((512, VIDEO_SEEDS), (128, 256)):
    args = _recorded(recorded, 'noise_chain', (batch, size, size), '22e')
    errs[f'noise_chain_{size}'] = _hold_noise_chain(
        dev, args, '22e on the video eval\'s and mesh PPO\'s renders:', gen)
  errs['clahe_pair_512'] = _hold_clahe_pair(
      _recorded(recorded, 'clahe_hist_lut', (VIDEO_SEEDS, 512, 512), '22e'),
      '22e clahe_hist_lut + clahe_remap on the video eval\'s frames')
  render = _recorded(recorded, 'clahe_small', (256, 128, 128), '22e')
  kw = {k: render[k] for k in ('clip_limit', 'grid_size', 'nbins')}
  errs['clahe_small_128'] = _hold_clahe_small(
      render['image'], kw, '22e clahe_small (256, 128, 128) on the mesh PPO '
      'run\'s renders')
  return errs


def _hold_pipeline_kernels(dev, recorded) -> dict:
  """Phase 21f: each kernel the pipeline launched against its twin on the
  inputs the pipeline gave it."""
  import torch

  gen = torch.Generator(device=dev).manual_seed(21)
  errs = {}
  for shape in ((1, 128, 128), (64, 256, 256)):
    errs[f'noise_chain {shape}'] = _hold_noise_chain(
        dev, _recorded(recorded, 'noise_chain', shape, '21f'),
        "21f on the pipeline's clean frames:", gen)
  render = _recorded(recorded, 'clahe_small', (1, 128, 128), '21f')
  kw = {k: render[k] for k in ('clip_limit', 'grid_size', 'nbins')}
  errs['clahe_small (1, 128, 128)'] = _hold_clahe_small(
      render['image'], kw, "21f clahe_small (1, 128, 128) on a recorded "
      'render')
  errs['clahe_pair (64, 256, 256)'] = _hold_clahe_pair(
      _recorded(recorded, 'clahe_hist_lut', (64, 256, 256), '21f'),
      "21f clahe_hist_lut + clahe_remap on the detector's record frames")
  return errs


# Phase 23a runs the rate-learner CLI for each classical learner type at its
# defaults (augmentation and bootstrap on, the MLP's max_iter 500) on phase
# 21's aligned file, with --num_models cut from 100 to CLASSICAL_MODELS. The
# bars are the JAX package's mean test accuracy on a CPU recording made as
# phase 21 makes its own (scripts/classical_bars.py, 2 models), less three
# binomial standard errors (PERF.md section 2).
CLASSICAL_MODELS = 2
CLASSICAL_LEARNERS = ('knn', 'sklearn_mlp', 'gp', 'random_forest', 'svm')
CLASSICAL_BARS = {
    'knn': 0.6541,
    'sklearn_mlp': 0.6621,
    'gp': 0.6621,
    'random_forest': 0.6621,
    'svm': 0.6621,
}
CLASSICAL_TIMEOUT_S = 600
# What 23a runs for each learner type: the rate-learner CLI's own parser
# and main, with the seconds spent in `joblib_io.dump` summed, then the
# fitted models' predict_proba on the committed queries (argv 1), saved
# with those seconds to argv 2 for the read-back check.
CLASSICAL_CLI = '''
import sys, time
import numpy as np
from putting_dune_torch.classifiers import joblib_io
from putting_dune_torch.pipeline import train_rate_learner as cli
dump, write_s = joblib_io.dump, [0.0]
def timed_dump(model, path):
  t0 = time.perf_counter()
  dump(model, path)
  write_s[0] += time.perf_counter() - t0
joblib_io.dump = timed_dump
_, _, models = cli.main(cli._parse_args(sys.argv[3:]))
queries = np.load(sys.argv[1])
np.savez(sys.argv[2], write_s=write_s[0],
         **{f'proba_{i}': m.predict_proba(queries)
            for i, m in enumerate(models)})
'''
CLASSIFIER_FIXTURES = os.path.join(ROOT, 'tests', 'data',
                                   'torch_classifiers')
JPEG_FIXTURES = os.path.join(ROOT, 'tests', 'data', 'torch_jpeg')
JPEG_REPEATS = 50


def classical_learners(dev, smi, aligned_path) -> dict:
  """Phase 23 (see the module docstring); returns the numbers it read."""
  import tempfile

  with tempfile.TemporaryDirectory(prefix='smoke_classical_') as tmp:
    return _classical_learners(dev, smi, aligned_path, tmp)


def _classical_learners(dev, smi, aligned_path, tmp) -> dict:
  import glob

  import numpy as np
  import torch

  from putting_dune_torch.classifiers import joblib_io
  from putting_dune_torch.io import datasets as datasets_lib
  from putting_dune_torch.io import jpeg
  from putting_dune_torch.io import records
  from putting_dune_torch.ops import _build
  from putting_dune_torch.proto import wire

  out = {}
  device_flag = [] if dev.type == 'cuda' else ['--device=cpu']
  _build.reset_launches()

  # -- 23a. the five classical learner types through the CLI, at once ---------
  print(f'23a --num_models cut from 100 to {CLASSICAL_MODELS}; everything '
        'else at the CLI defaults', flush=True)
  queries_path = os.path.join(CLASSIFIER_FIXTURES, 'queries.npy')
  queries = np.load(queries_path)
  procs, started, logs = {}, {}, {}
  for learner in CLASSICAL_LEARNERS:
    workdir = os.path.join(tmp, learner)
    logs[learner] = open(os.path.join(tmp, f'{learner}.log'), 'w+')
    started[learner] = time.perf_counter()
    procs[learner] = subprocess.Popen(
        [sys.executable, '-c', CLASSICAL_CLI, queries_path,
         os.path.join(tmp, f'{learner}_fitted.npz'),
         f'--source_path={aligned_path}', f'--workdir={workdir}',
         f'--learner_type={learner}', f'--num_models={CLASSICAL_MODELS}',
         '--previous_controls_at_current_timestep', *device_flag],
        cwd=ROOT, stdout=logs[learner], stderr=subprocess.STDOUT, text=True)
  runs = {}
  try:
    # Each learner's seconds run from the common start to its own exit.
    while len(runs) < len(procs):
      for learner, proc in procs.items():
        if learner not in runs and proc.poll() is not None:
          runs[learner] = time.perf_counter() - started[learner]
      check(time.perf_counter() - min(started.values())
            < CLASSICAL_TIMEOUT_S, f'23a: still running after '
            f'{CLASSICAL_TIMEOUT_S} s: {sorted(set(procs) - set(runs))}')
      time.sleep(0.05)
  finally:
    for proc in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  texts = {}
  for learner, log in logs.items():
    log.seek(0)
    texts[learner] = log.read()
    log.close()
  learners = {}
  for learner in CLASSICAL_LEARNERS:
    text, seconds = texts[learner], runs[learner]
    check(procs[learner].returncode == 0, f'23a: train_rate_learner '
          f'--learner_type={learner} failed:\n{text[-3000:]}')
    workdir = os.path.join(tmp, learner)
    metrics = np.load(os.path.join(workdir, 'metrics.npz'))
    train_acc = float(metrics['train_accuracy'].mean())
    test_acc = float(metrics['test_accuracy'].mean())
    on = sorted(set(line.rsplit('fitted tensors on ', 1)[1].rstrip(')')
                    for line in text.splitlines()
                    if 'fitted tensors on ' in line))
    rows = [line.split('(', 1)[1].split(' rows', 1)[0]
            for line in text.splitlines() if 'fitted tensors on ' in line]
    files = sorted(os.listdir(workdir))
    fitted = np.load(os.path.join(tmp, f'{learner}_fitted.npz'))
    write_s = float(fitted['write_s'])
    mb = sum(os.path.getsize(os.path.join(workdir, f)) for f in files
             if f.endswith(joblib_io.SUFFIX)) / 1e6
    bar = CLASSICAL_BARS[learner]
    print(f'23a {learner}: {seconds:.2f} s (five at once; of it {write_s:.2f} '
          f's writing {mb:.2f} MB of .joblib files), {CLASSICAL_MODELS} '
          f'models of {rows} rows, train accuracy {train_acc:.4f}, test '
          f'accuracy {test_acc:.4f} (bar {bar}), fitted tensors on {on}, '
          f'files {files}', flush=True)
    check(on == [str(torch.device(dev.type, 0)) if dev.type == 'cuda'
                 else 'cpu'],
          f'23a {learner}: fitted tensors on {on}, not on {dev}')
    check(len(metrics['test_accuracy']) == CLASSICAL_MODELS
          and np.isfinite(metrics['test_accuracy']).all(),
          f'23a {learner}: test accuracies missing or not finite')
    check(bar is None or test_acc >= bar,
          f'23a {learner}: test accuracy {test_acc:.4f} below the bar {bar}')
    want = sorted([f'{learner}_{i}{joblib_io.SUFFIX}'
                   for i in range(CLASSICAL_MODELS)]
                  + [f'{learner}_ensemble{joblib_io.SUFFIX}', 'metrics.npz',
                     'avg_context_rates.png'])
    check(files == want, f'23a {learner}: wrote {files}, expected {want}')
    # The files read back by the port's reader, held to the fitted models.
    t0 = time.perf_counter()
    probas = [torch.as_tensor(fitted[f'proba_{i}'], device=dev)
              for i in range(CLASSICAL_MODELS)]
    err = 0.0
    for i, want_proba in enumerate(probas):
      back = joblib_io.load(os.path.join(
          workdir, f'{learner}_{i}{joblib_io.SUFFIX}'), device=dev)
      got = back.predict_proba_tensor(queries)
      check(got.device.type == dev.type, f'23a {learner}: read onto '
            f'{got.device}')
      err = max(err, float((got - want_proba).abs().max()))
    ensemble = joblib_io.load(os.path.join(
        workdir, f'{learner}_ensemble{joblib_io.SUFFIX}'), device=dev)
    err = max(err, float((ensemble.predict_proba_tensor(queries)
                          - torch.stack(probas).mean(dim=0)).abs().max()))
    read_s = time.perf_counter() - t0
    print(f'23a {learner}: the .joblib files read back on {dev.type} in '
          f'{read_s:.2f} s: max|d| {err:.3g} of predict_proba on '
          f'{len(queries)} queries against the fitted models', flush=True)
    check(err <= 1e-12, f'23a {learner}: max|d| {err} > 1e-12')
    learners[learner] = dict(seconds=seconds, train_accuracy=train_acc,
                             test_accuracy=test_acc, bar=bar, device=on,
                             write_s=write_s, mb=mb, read_s=read_s,
                             max_abs_err=err)
  out['learners'] = learners

  # -- 23b. the JAX package's learner files, on the card ------------------------
  errors = {}
  for name in CLASSICAL_LEARNERS + ('ensemble',):
    t0 = time.perf_counter()
    model = joblib_io.load(os.path.join(CLASSIFIER_FIXTURES,
                                        f'{name}.joblib'), device=dev)
    got = model.predict_proba_tensor(queries)
    check(got.device.type == dev.type and got.dtype == torch.float64,
          f'23b {name}: predict_proba on {got.device}, {got.dtype}')
    want = np.load(os.path.join(CLASSIFIER_FIXTURES, f'{name}_proba.npy'))
    errors[name] = float(np.abs(got.cpu().numpy() - want).max())
    print(f'23b {name}.joblib read and predicted on {got.device} in '
          f'{time.perf_counter() - t0:.3f} s: max|d| {errors[name]:.3g} '
          f'against sklearn on {len(queries)} queries', flush=True)
    check(errors[name] <= 1e-9, f'23b {name}: max|d| {errors[name]} > 1e-9')
  out['joblib_max_abs_err'] = errors

  # -- 23c. JPEG on the host, and a TFDS shard of them through the CLI ---------
  names = sorted(os.path.basename(p)[:-4]
                 for p in glob.glob(os.path.join(JPEG_FIXTURES, '*.jpg')))
  check(len(names) >= 8, f'23c: {len(names)} JPEG fixtures')
  payloads, pixels = {}, {}
  for name in names:
    with open(os.path.join(JPEG_FIXTURES, f'{name}.jpg'), 'rb') as f:
      payloads[name] = f.read()
    pixels[name] = np.load(os.path.join(JPEG_FIXTURES, f'{name}.npy'))
    got = jpeg.imdecode(payloads[name])
    check(got.shape == pixels[name].shape, f'23c {name}: shape {got.shape}')
    err = int(np.abs(got.astype(int) - pixels[name]).max())
    check(err == 0, f'23c {name}: max|d| {err} against cv2')
  nbytes = sum(len(p) for p in payloads.values())
  npx = sum(p.shape[0] * p.shape[1] for p in pixels.values())
  t0 = time.perf_counter()
  for _ in range(JPEG_REPEATS):
    for p in payloads.values():
      jpeg.imdecode(p)
  decode_s = (time.perf_counter() - t0) / JPEG_REPEATS
  print(f'23c {len(names)} JPEGs decoded on the host, max|d| 0 against cv2: '
        f'{nbytes / 1e6 / decode_s:.2f} MB/s, {npx / 1e6 / decode_s:.2f} '
        f'Mpx/s ({nbytes} bytes, {npx} pixels, {JPEG_REPEATS} passes)',
        flush=True)
  dataset = os.path.join(tmp, 'tfds', 'jpegs', '1.0.0')
  os.makedirs(dataset)
  image_type = 'tensorflow_datasets.core.features.image_feature.Image'
  with open(os.path.join(dataset, 'features.json'), 'w') as f:
    json.dump({'type': ('tensorflow_datasets.core.features.features_dict'
                        '.FeaturesDict'),
               'content': {'features': {'image': {
                   'type': image_type,
                   'content': {'shape': [None, None, None], 'dtype': 'uint8',
                               'encoding_format': 'jpeg'}}}}}, f)
  examples = [wire.ExampleCompat(features=wire.FeaturesCompat(feature={
      'image': wire.FeatureCompat(bytes_list=wire.BytesListCompat(
          value=[payloads[name]]))})).SerializeToString() for name in names]
  records.write_tfrecords(
      os.path.join(dataset, 'jpegs-train.tfrecord-00000-of-00001'), examples)
  t0 = time.perf_counter()
  run = subprocess.run(
      [sys.executable, '-m', 'putting_dune_torch.pipeline.import_tfds_dataset',
       f'--dataset_dir={dataset}', f'--output_dir={os.path.join(tmp, "imp")}'],
      cwd=ROOT, capture_output=True, text=True, timeout=300)
  import_s = time.perf_counter() - t0
  check(run.returncode == 0, '23c: import_tfds_dataset failed:\n'
        + run.stdout[-2000:] + run.stderr[-2000:])
  imported = list(datasets_lib.iterate_examples(
      datasets_lib.split_dir(os.path.join(tmp, 'imp'), 'train')))
  check(len(imported) == len(names), f'23c: {len(imported)} examples back')
  for name, example in zip(names, imported):
    want = pixels[name]
    want = want[..., None] if want.ndim == 2 else want[..., ::-1]
    check(np.array_equal(example['image'], want),
          f'23c {name}: the imported image differs from cv2 in RGB')
  print(f'23c import_tfds_dataset CLI on a shard of {len(names)} JPEG '
        f'features: {import_s:.2f} s, every image equal to cv2\'s in RGB',
        flush=True)
  out['jpeg'] = dict(mb_s=nbytes / 1e6 / decode_s,
                     mpx_s=npx / 1e6 / decode_s, import_s=import_s)

  # -- 23d. no kernel of its own --------------------------------------------------
  launches = {k: v for k, v in _build.LAUNCHES.items() if v}
  print('23d no new kernel: the learners run PyTorch float64 ops on the '
        'card (cuSOLVER Cholesky, cuBLAS GEMMs, sort / topk) and the JPEG '
        f'decoder is host C++; hand-kernel launches in this process during '
        f'phase 23: {launches}', flush=True)
  return out


# Phase 25: the subpackages' public names, the learners' sklearn files and
# SavedModels with gradients.
PUBLIC_SUBPACKAGES = ('agents', 'alignment', 'atom_detection', 'env',
                      'graph_alignment', 'image_alignment', 'imaging',
                      'parallel', 'experiments')
# A loaded export's gradient against native autograd on the card, both in
# full float32: max|d| <= tol * (1 + max|native gradient|).
GRADIENT_TOL = {'atom_detector': 1e-4, 'image_aligner': 1e-4,
                'rate_predictor': 1e-5, 'mlp_policy': 1e-5}


def gaps_to_the_jax_package(dev, smi) -> dict:
  """Phase 25 (see the module docstring); returns the numbers it read."""
  import tempfile

  with tempfile.TemporaryDirectory(prefix='smoke_gaps_') as tmp:
    return _gaps_to_the_jax_package(dev, smi, tmp)


def _gaps_to_the_jax_package(dev, smi, tmp) -> dict:
  import importlib

  import torch

  from putting_dune_torch import registry
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.atom_detection import model as det_model
  from putting_dune_torch.atom_detection import train as det_train
  from putting_dune_torch.image_alignment import model as align_model
  from putting_dune_torch.image_alignment import train as align_train
  from putting_dune_torch.io import stablehlo
  from putting_dune_torch.io import tf_export
  from putting_dune_torch.ops import _build
  from putting_dune_torch.rate_learning import config as rl_config
  from putting_dune_torch.rate_learning import predictor as predictor_lib

  out = {}
  _build.reset_launches()

  # -- 25a. the subpackages' public names ---------------------------------------
  names = 0
  for sub in PUBLIC_SUBPACKAGES:
    package = importlib.import_module(f'putting_dune_torch.{sub}')
    for name in package.__all__:
      check(getattr(package, name, None) is not None,
            f'25a: putting_dune_torch.{sub} lacks {name}')
      names += 1
  from putting_dune_torch.experiments import registry as exp_registry  # pylint: disable=g-import-not-at-top
  check(exp_registry is registry, '25a: experiments.registry is a copy')
  print(f'25a {names} re-exported names of {len(PUBLIC_SUBPACKAGES)} '
        'subpackages imported; experiments.registry is the registry',
        flush=True)
  out['public_names'] = names

  # -- 25b. the shipped models exported with their gradients -------------------
  weights = eval_agent.MODEL_WEIGHTS_DIR
  detector = det_model.UNet(features=tuple(det_train.load_arch(os.path.join(
      weights, 'atom_detector'))['features']))
  detector.load_state_dict(det_model.params_from_flax(det_train.load_params(
      os.path.join(weights, 'atom_detector'))))
  aligner = align_model.from_flax(align_train.load_params(
      os.path.join(weights, 'image_aligner')))
  predictor = predictor_lib.LearnedRatePredictor(
      config=rl_config.RateLearningConfig(beam_units='angstroms'), device=dev)
  predictor.load(os.path.join(weights, 'rate_predictor'))
  policy = eval_agent.load_policy(os.path.join(weights, '230422_ppo_v3_2s'),
                                  dev).eval()
  rate_mean = predictor_lib._EnsembleMean(predictor.model.eval(), None)  # pylint: disable=protected-access
  shipped = {
      'atom_detector': (detector.to(dev).eval(), (1, 256, 256, 1)),
      'image_aligner': (aligner.to(dev).eval(), (1, 128, 128, 5)),
      'rate_predictor': (rate_mean, (1, predictor.context_dim)),
      'mlp_policy': (policy, (policy.obs_dim,)),
  }
  gen = torch.Generator(device=dev).manual_seed(25)
  gradients = {}
  for name, (module, shape) in shipped.items():
    for param in module.parameters():
      param.requires_grad_(False)
    path = os.path.join(tmp, f'{name}_with_gradient')
    _sync(dev)
    t0 = time.perf_counter()
    tf_export.export_tf_saved_model(module, shape, path, with_gradient=True)
    export_s = time.perf_counter() - t0
    loaded = tf_export.load_tf_saved_model(path, device=dev)
    x = torch.randn(shape, generator=gen, device=dev)
    with stablehlo.full_float32():
      outs = module(x)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cotangents = [torch.randn(o.shape, generator=gen, device=dev)
                  for o in outs]

    def gradient(fn, x=x, cotangents=cotangents):
      xg = x.clone().requires_grad_(True)
      with stablehlo.full_float32():
        got = fn(xg)
        got = got if isinstance(got, tuple) else (got,)
        total = sum((g * c).sum() for g, c in zip(got, cotangents))
        return torch.autograd.grad(total, xg)[0]

    want = gradient(module)
    t0 = time.perf_counter()
    got = gradient(loaded)
    _sync(dev)
    grad_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    mb = _dir_mb(path)
    print(f'25b {name} {shape} with_gradient: export {export_s:.2f} s, '
          f'{mb:.2f} MB; the loader\'s autograd gradient on {got.device} in '
          f'{grad_s:.3f} s, max|d| {err:.3g} against native autograd (bar '
          f'{GRADIENT_TOL[name]:g} x (1 + {scale:.3g})) on {smi}', flush=True)
    check(got.device.type == dev.type, f'25b {name}: gradient on {got.device}')
    check(err <= GRADIENT_TOL[name] * (1 + scale),
          f'25b {name}: the loaded gradient differs from native autograd')
    gradients[name] = dict(export_s=export_s, mb=mb, gradient_s=grad_s,
                           max_abs_err=err, max_abs_gradient=scale)
  out['with_gradient'] = gradients
  launches = {k: v for k, v in _build.LAUNCHES.items() if v}
  print('25c no new kernel: the exports trace PyTorch ops and the loader '
        'runs StableHLO as PyTorch ops; hand-kernel launches in this process '
        f'during phase 25: {launches}', flush=True)
  return out


# Phase 26: the JAX package's keywords on the reference pixel loop and the
# vector loop. On the 30-column lattice the JAX package's
# `greedy_simple_rates` reaches the goal on 1000 of medium_eval's 1000 seeds
# on the CPU, in 8.715 actions (standard error 0.123;
# `scripts/eval_cpu_pair.py --experiment_name=greedy_simple_rates
# --seeds=medium_eval --grid_columns=30 --batch_size=1000`): the port must
# reach GREEDY_GRID30_BAR, and its actions lie within
# GREEDY_GRID30_ACTIONS[1] of GREEDY_GRID30_ACTIONS[0].
API_MAX_STEPS = 100
GREEDY_GRID30_BAR = 0.99
GREEDY_GRID30_ACTIONS = (8.715, 1.0)


def api_parity(dev, smi, path_launches) -> dict:
  """Phase 26 (see the module docstring); returns the numbers it read. Its
  files are a temporary directory, removed after."""
  import tempfile

  recorded = {}
  with tempfile.TemporaryDirectory(prefix='smoke_api_') as tmp:
    with _recording_inputs(recorded):
      out = _api_parity(dev, smi, path_launches, tmp)
  out['twins'] = _hold_phase26_kernels(dev, recorded)
  return out


def _api_parity(dev, smi, path_launches, tmp) -> dict:
  import math

  import torch

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import eval_lib
  from putting_dune_torch import lattice as lattice_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.ops import _build

  out = {}

  # -- 26a. chunk_steps 1 and 64 at the reference pixel loop --------------------
  name = 'ppo_simple_images_tf'
  experiment = registry.create_eval_experiment(name)
  seeds = list(eval_lib.EVAL_SUITES['small_eval'])

  def pixel_env():
    return run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=len(seeds), device=dev)

  policy = eval_cli.policy_for_agent(
      experiment.get_policy(experiment.get_adapters_and_goal(), dev))
  runs = {}
  for chunk in (1, 64):
    env = pixel_env()
    _build.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    results = eval_lib.evaluate_batched(env, policy, seeds,
                                        chunk_steps=chunk)
    _sync(dev)
    seconds = time.perf_counter() - t0
    counted = dict(_build.LAUNCHES)
    path_launches[f'api_parity_chunk_{chunk}_512'] = counted
    agg = eval_lib.aggregate_results(results)
    steps = len(seeds) * max(r.num_actions_taken for r in results)
    kernels = {k: counted[k] for k in ('noise_chain', 'clahe_hist_lut',
                                       'clahe_remap')}
    print(f'26a {name} small_eval chunk_steps={chunk}: success '
          f'{agg.average_num_times_reached_goal}, actions '
          f'{agg.average_num_actions_taken:.2f}, {steps} env steps in '
          f'{seconds:.3f} s = {steps / seconds:.1f} env steps/s, launches '
          f'{kernels} on {smi}', flush=True)
    for kernel, count in kernels.items():
      check(count > 0, f'26a: {kernel} was not launched')
    check(agg.average_num_times_reached_goal >= 0.95,
          f'26a: success {agg.average_num_times_reached_goal} at '
          f'chunk_steps={chunk}')
    runs[chunk] = results
    out[f'chunk_{chunk}'] = dict(
        success=agg.average_num_times_reached_goal,
        actions=agg.average_num_actions_taken, seconds=seconds,
        env_steps_per_s=steps / seconds, launches=kernels)
  check(_same_results(runs[1], runs[64]),
        '26a: chunk_steps=1 and chunk_steps=64 give different results')

  # -- 26b. max_steps ------------------------------------------------------------
  capped = eval_lib.evaluate_batched(pixel_env(), policy, seeds,
                                     max_steps=API_MAX_STEPS)
  at_cap = 0
  for whole, cut in zip(runs[64], capped):
    if whole.num_actions_taken <= API_MAX_STEPS:
      check(_same_results([whole], [cut]),
            f'26b: seed {cut.seed} differs under max_steps')
    else:
      at_cap += 1
      check(not cut.reached_goal and cut.num_actions_taken == API_MAX_STEPS
            and math.isnan(cut.environment_seconds_to_goal),
            f'26b: seed {cut.seed} is not stopped at the cap')
  print(f'26b max_steps={API_MAX_STEPS}: {at_cap} of {len(seeds)} episodes '
        f'stopped at the cap, not reached; the other {len(seeds) - at_cap} '
        'as without the cap', flush=True)
  out['max_steps'] = dict(cap=API_MAX_STEPS, at_cap=at_cap)

  # -- 26c. grid_columns ---------------------------------------------------------
  greedy = registry.create_eval_experiment('greedy_simple_rates')
  wide = list(eval_lib.EVAL_SUITES['medium_eval'])
  env = run_helpers.create_batched_env(
      greedy.get_adapters_and_goal, greedy.get_simulator_config,
      batch_size=len(wide), grid_columns=30, device=dev)
  want = lattice_lib.make_lattice(30, dev)
  check(env.config.sim.grid_columns == 30
        and torch.equal(env.lattice.positions, want.positions)
        and torch.equal(env.lattice.neighbors, want.neighbors),
        '26c: the env does not hold make_lattice(30)')
  _sync(dev)
  t0 = time.perf_counter()
  results = eval_lib.evaluate_batched(
      env, eval_cli.policy_for_agent(
          greedy.get_policy(greedy.get_adapters_and_goal(), dev)), wide)
  _sync(dev)
  seconds = time.perf_counter() - t0
  agg = eval_lib.aggregate_results(results)
  print(f'26c greedy_simple_rates grid_columns=30 batch {len(wide)}: success '
        f'{agg.average_num_times_reached_goal} (bar {GREEDY_GRID30_BAR}), '
        f'actions {agg.average_num_actions_taken:.3f} (JAX '
        f'{GREEDY_GRID30_ACTIONS[0]} +- {GREEDY_GRID30_ACTIONS[1]}), '
        f'{seconds:.3f} s on {smi}', flush=True)
  check(agg.average_num_times_reached_goal >= GREEDY_GRID30_BAR,
        '26c: greedy success on the 30-column lattice')
  check(abs(agg.average_num_actions_taken - GREEDY_GRID30_ACTIONS[0])
        <= GREEDY_GRID30_ACTIONS[1],
        '26c: greedy actions on the 30-column lattice')
  out['grid_30'] = dict(success=agg.average_num_times_reached_goal,
                        actions=agg.average_num_actions_taken,
                        seconds=seconds)

  # -- 26d. EvalAgent: save, params, from_actor_critic ---------------------------
  shipped_dir = os.path.join(eval_agent.MODEL_WEIGHTS_DIR, name)
  shipped = eval_agent.EvalAgent.load(shipped_dir, dev)
  saved_dir = os.path.join(tmp, 'saved')
  shipped.save(saved_dir)
  reloaded = eval_agent.EvalAgent.load(saved_dir, dev)
  with open(os.path.join(shipped_dir, 'policy.json')) as f:
    arch = json.load(f)['arch']
  rebuilt = eval_agent.EvalAgent.from_actor_critic(shipped.params, **arch,
                                                   device=dev)
  _, ts = pixel_env().reset(env_lib.make_generator(26, dev))
  frames = ts.observation
  want_actions = shipped.policy()(None, frames)
  errs = {}
  for label, agent in (('save -> load', reloaded),
                       ('from_actor_critic', rebuilt)):
    got = agent.policy()(None, frames)
    check(got.device.type == dev.type, f'26d {label}: actions on {got.device}')
    errs[label] = float((got - want_actions).abs().max())
    print(f"26d {label}: actions on {got.device} for "
          f"{tuple(frames['image'].shape)} frames, max|d| {errs[label]:.3g} "
          'against the shipped agent (bar 0)', flush=True)
    check(errs[label] == 0.0, f'26d {label}: actions differ')
  out['agents_max_abs_err'] = errs
  return out


def _hold_phase26_kernels(dev, recorded) -> dict:
  """Phase 26e: noise_chain and the CLAHE pair against their twins on the
  frames the 512^2 evals gave them."""
  import torch

  gen = torch.Generator(device=dev).manual_seed(26)
  return {
      'noise_chain_512': _hold_noise_chain(
          dev, _recorded(recorded, 'noise_chain', (100, 512, 512), '26e'),
          "26e on the pixel eval's clean renders:", gen),
      'clahe_pair_512': _hold_clahe_pair(
          _recorded(recorded, 'clahe_hist_lut', (100, 512, 512), '26e'),
          "26e clahe_hist_lut + clahe_remap on the pixel eval's frames"),
  }


# Phase 24: TF SavedModel interop and the authenticated GCS download.
SAVED_MODEL_FIXTURES = os.path.join(ROOT, 'tests', 'data', 'torch_saved_models')
# (rtol, atol) of the committed JAX fixtures against their recorded outputs:
# the JAX test's own for the UNets, 1e-5 for the MLPs.
SAVED_MODEL_TOLERANCES = {'mlp_policy': (1e-5, 1e-5),
                          'rate_predictor': (1e-5, 1e-6),
                          'atom_detector': (1e-3, 1e-4),
                          'image_aligner': (1e-3, 1e-4)}
# An export of a shipped model against its native forward on the card,
# both in full float32: max|d| <= tol * (1 + max|native|).
SAVED_MODEL_EXPORT_TOL = {'atom_detector': 1e-4, 'image_aligner': 1e-4,
                          'rate_predictor': 1e-5, 'mlp_policy': 1e-5}
SAVED_MODEL_SCENES = 4
SAVED_MODEL_EPISODE_STEPS = 20
GCS_OBJECT_MB = 8


@contextlib.contextmanager
def _environ(**values):
  """Environment variables set (None: removed) while open."""
  saved = {k: os.environ.get(k) for k in values}
  try:
    for k, v in values.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
    yield
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


def _dir_mb(path: str) -> float:
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files) / 1e6


def saved_model_interop(dev, smi, path_launches) -> dict:
  """Phase 24 (see the module docstring); returns the numbers it read."""
  import tempfile

  with tempfile.TemporaryDirectory(prefix='smoke_saved_model_') as tmp:
    return _saved_model_interop(dev, smi, path_launches, tmp)


def _saved_model_interop(dev, smi, path_launches, tmp) -> dict:
  import base64
  import hashlib

  import numpy as np
  import torch

  from putting_dune_torch import eval_lib
  from putting_dune_torch import lattice as lattice_lib
  from putting_dune_torch import microscope_agent
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.atom_detection import data as det_data
  from putting_dune_torch.atom_detection import model as det_model
  from putting_dune_torch.atom_detection import train as det_train
  from putting_dune_torch.image_alignment import inference as alignment
  from putting_dune_torch.image_alignment import model as align_model
  from putting_dune_torch.image_alignment import train as align_train
  from putting_dune_torch.io import gcs
  from putting_dune_torch.io import stablehlo
  from putting_dune_torch.io import tf_export
  from putting_dune_torch.ops import _build
  from putting_dune_torch.rate_learning import config as rl_config
  from putting_dune_torch.rate_learning import predictor as predictor_lib

  out = {}
  weights = eval_agent.MODEL_WEIGHTS_DIR

  # -- 24a. the shipped models exported at full width, reloaded on the card ---
  detector = det_model.UNet(features=tuple(det_train.load_arch(os.path.join(
      weights, 'atom_detector'))['features']))
  detector.load_state_dict(det_model.params_from_flax(det_train.load_params(
      os.path.join(weights, 'atom_detector'))))
  aligner = align_model.from_flax(align_train.load_params(
      os.path.join(weights, 'image_aligner')))
  predictor = predictor_lib.LearnedRatePredictor(
      config=rl_config.RateLearningConfig(beam_units='angstroms'), device=dev)
  predictor.load(os.path.join(weights, 'rate_predictor'))
  policy = eval_agent.load_policy(os.path.join(weights, '230422_ppo_v3_2s'),
                                  dev)
  # name: (native forward, input shape, input name, module to export; None:
  # the predictor's own export_tf).
  detector, aligner = detector.to(dev).eval(), aligner.to(dev).eval()
  native = {
      'atom_detector': (detector, (1, 256, 256, 1), 'image', detector),
      'image_aligner': (aligner, (1, 128, 128, 5), 'image', aligner),
      'rate_predictor': (predictor.apply_model, (1, predictor.context_dim),
                         'beam_position', None),
      'mlp_policy': (policy.eval(), (policy.obs_dim,), 'input', policy),
  }
  loaded = {}
  gen = torch.Generator(device=dev).manual_seed(24)
  for name, (module, shape, input_name, exported) in native.items():
    path = os.path.join(tmp, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if exported is None:
      predictor.export_tf(path)
    else:
      tf_export.export_tf_saved_model(exported, shape, path,
                                      input_name=input_name)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = tf_export.load_tf_saved_model(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded[name] = model
    x = torch.randn(shape, generator=gen, device=dev)
    with torch.no_grad(), stablehlo.full_float32():
      want = module(x)
    got = model(x)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    with stablehlo.full_float32():
      native_ms = time_ms(lambda m=module, x=x: m(x), repeats=10)
    interp_ms = time_ms(lambda m=model, x=x: m(x), repeats=10)
    mb = _dir_mb(path)
    print(f'24a {name} {shape}: export {export_s:.2f} s, load {load_s:.2f} '
          f's, {mb:.2f} MB; interpreter forward {interp_ms:.3f} ms beside '
          f'the native {native_ms:.3f} ms (full float32, median of 10); '
          f'max|d| {err:.3g} (bar {SAVED_MODEL_EXPORT_TOL[name]:g} x '
          f'(1 + {scale:.3g})) on {smi}', flush=True)
    check(err <= SAVED_MODEL_EXPORT_TOL[name] * (1 + scale),
          f'24a: the exported {name} differs from its native forward')
    out[name] = dict(export_s=export_s, load_s=load_s, mb=mb,
                     interpreter_ms=interp_ms, native_ms=native_ms,
                     max_abs_err=err)

  # -- 24b. rendered scenes and aligner stacks through the loaded models ------
  recorded = {}
  _build.reset_launches()
  with _recording_inputs(recorded):
    lattice = lattice_lib.make_lattice(50, dev)
    batch = det_data.sample_batch(gen, lattice, batch_size=SAVED_MODEL_SCENES,
                                  image_size=256, noisy=True)
    sequence, _ = microscope_agent.drifting_sequence(0, frames=6, device=dev)
    frames = alignment.ImageAligner.from_checkpoint(device=dev)
    stack = np.concatenate([frames.preprocess(o.image) for o in sequence[-5:]],
                           axis=-1)
  counted = dict(_build.LAUNCHES)
  det_err = det_scale = 0.0
  agree = []
  for image in batch['image']:
    x = image[None]
    with torch.no_grad(), stablehlo.full_float32():
      want = detector(x)
    got = loaded['atom_detector'](x)
    det_err = max(det_err, float((got - want).abs().max()))
    det_scale = max(det_scale, float(want.abs().max()))
    agree.append(float((got.argmax(-1) == want.argmax(-1)).float().mean()))
  x = torch.as_tensor(stack, device=dev)[None]
  with torch.no_grad(), stablehlo.full_float32():
    want = aligner(x)
  got = loaded['image_aligner'](x)
  align_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
  align_scale = max(float(w.abs().max()) for w in want)
  path_launches['saved_model_scenes'] = counted
  print(f'24b {SAVED_MODEL_SCENES} noisy 256^2 scenes through the loaded '
        f'detector: max|d| {det_err:.3g} against the native forward, argmax '
        f'agreement {min(agree):.4f} at least; one 128^2 x 5 aligner stack '
        f'(clahe_small frames): max|d| {align_err:.3g}; launches {counted}',
        flush=True)
  check(det_err <= SAVED_MODEL_EXPORT_TOL['atom_detector'] * (1 + det_scale),
        '24b: detector logits differ')
  check(min(agree) >= 0.999, '24b: detector classes differ')
  check(align_err <= SAVED_MODEL_EXPORT_TOL['image_aligner'] * (
      1 + align_scale), '24b: aligner outputs differ')
  for kernel in ('noise_chain', 'clahe_hist_lut', 'clahe_remap',
                 'clahe_small'):
    check(counted[kernel] > 0, f'24b: {kernel} was not launched')
  errs = {}
  hold_gen = torch.Generator(device=dev).manual_seed(241)
  args = _recorded(recorded, 'noise_chain',
                   (SAVED_MODEL_SCENES, 256, 256), '24b')
  errs['noise_chain_256'] = _hold_noise_chain(
      dev, args, '24b on the scenes:', hold_gen)
  errs['clahe_pair_256'] = _hold_clahe_pair(
      _recorded(recorded, 'clahe_hist_lut', (SAVED_MODEL_SCENES, 256, 256),
                '24b'), '24b clahe_hist_lut + clahe_remap on the scenes')
  small = _recorded(recorded, 'clahe_small', (1, 128, 128), '24b')
  errs['clahe_small_128'] = _hold_clahe_small(
      small['image'], {k: small[k] for k in ('clip_limit', 'grid_size',
                                             'nbins')},
      '24b clahe_small (1, 128, 128) on an aligner frame')
  out['scenes'] = dict(detector_max_abs_err=det_err,
                       aligner_max_abs_err=align_err, holds=errs)

  # -- 24c. the committed JAX-made SavedModels on the card ---------------------
  for name, (rtol, atol) in SAVED_MODEL_TOLERANCES.items():
    root = os.path.join(SAVED_MODEL_FIXTURES, name)
    model = tf_export.load_tf_saved_model(os.path.join(root, 'saved_model'),
                                          device=dev)
    got = model(np.load(os.path.join(root, 'input.npy')))
    got = got if isinstance(got, tuple) else (got,)
    worst = 0.0
    for i, g in enumerate(got):
      want = np.load(os.path.join(root, f'output_{i}.npy'))
      g = g.cpu().numpy()
      check(bool(np.allclose(g, want, rtol=rtol, atol=atol)),
            f'24c: the JAX {name} export differs from its recorded output')
      worst = max(worst, float(np.abs(g - want).max()))
    print(f'24c JAX-made {name} on the card: max|d| {worst:.3g} against '
          f'JAX\'s recorded output (rtol {rtol:g}, atol {atol:g})',
          flush=True)
    out[f'jax_{name}'] = worst

  # -- 24d. the host evaluator through TfSavedModelAgent ----------------------
  experiment = registry.create_eval_experiment('eval_ppo_v3_2s')
  tf_agent = eval_agent.TfSavedModelAgent(os.path.join(tmp, 'mlp_policy'),
                                          device=dev)
  native_agent = eval_agent.EvalAgent(policy)
  diffs = []

  class Paired:
    """Acts with the SavedModel agent; holds each action to EvalAgent's."""

    def step(self, time_step):
      action = tf_agent.step(time_step)
      diffs.append(float(np.abs(action - native_agent.step(time_step)).max()))
      return action

    def set_mode(self, mode):
      tf_agent.set_mode(mode)
      native_agent.set_mode(mode)

  env = run_helpers.create_putting_dune_env(
      0, experiment.get_adapters_and_goal, experiment.get_simulator_config,
      simulator_step_limit=SAVED_MODEL_EPISODE_STEPS, device=dev)
  t0 = time.perf_counter()
  (result,) = eval_lib.evaluate(Paired(), env, [0])
  episode_s = time.perf_counter() - t0
  print(f'24d host evaluator, eval_ppo_v3_2s seed 0 through '
        f'TfSavedModelAgent: {result.num_actions_taken} actions in '
        f'{episode_s:.2f} s, each against EvalAgent\'s: max|d| '
        f'{max(diffs):.3g} (bar 1e-5)', flush=True)
  check(len(diffs) == result.num_actions_taken and diffs,
        '24d: the evaluator took no action')
  check(max(diffs) <= 1e-5, '24d: TfSavedModelAgent differs from EvalAgent')
  out['episode'] = dict(actions=result.num_actions_taken,
                        max_abs_err=max(diffs), seconds=episode_s)

  # -- 24e. the authenticated GCS download against a loopback server ----------
  # The tests' throwaway key: the card's machine has no crypto package.
  with open(os.path.join(ROOT, 'tests', 'data', 'torch_gcs',
                         'throwaway_rsa_key.pem')) as f:
    pem = f.read()
  payload = os.urandom(GCS_OBJECT_MB << 20)
  sys.path.insert(0, os.path.join(ROOT, 'tests'))
  import torch_gcs_server  # the tests' loopback token and storage server

  storage = torch_gcs_server.LoopbackGoogle()
  storage.objects[('smoke-bucket', 'models/blob.bin')] = payload
  try:
    info = {'type': 'service_account', 'private_key_id': 'smoke',
            'private_key': pem, 'client_email': 'smoke@example.invalid',
            'token_uri': f'{storage.url}/token'}
    creds_path = os.path.join(tmp, 'service_account.json')
    with open(creds_path, 'w') as f:
      json.dump(info, f)
    with _environ(GOOGLE_APPLICATION_CREDENTIALS=creds_path,
                  API_ENDPOINT_OVERRIDE=storage.url,
                  STORAGE_EMULATOR_HOST=None, NO_PROXY='127.0.0.1,localhost',
                  http_proxy=None, https_proxy=None, HTTP_PROXY=None,
                  HTTPS_PROXY=None, ALL_PROXY=None, all_proxy=None):
      credentials = gcs.default_credentials()
      t0 = time.perf_counter()
      for _ in range(10):
        assertion = credentials.assertion()
      sign_ms = 1e3 * (time.perf_counter() - t0) / 10
      signing_input, _, signature = assertion.rpartition(b'.')
      s = int.from_bytes(base64.urlsafe_b64decode(
          signature + b'=' * (-len(signature) % 4)), 'big')
      em = pow(s, credentials.key.e, credentials.key.n).to_bytes(
          credentials.key.size, 'big')
      check(em.endswith(hashlib.sha256(signing_input).digest())
            and em.startswith(b'\x00\x01\xff'), '24e: bad RS256 signature')
      t0 = time.perf_counter()
      token = credentials.token()
      grant_ms = 1e3 * (time.perf_counter() - t0)
      target = os.path.join(tmp, 'blob.bin')
      t0 = time.perf_counter()
      gcs.download('smoke-bucket', 'models/blob.bin', target,
                   credentials=credentials)
      download_ms = 1e3 * (time.perf_counter() - t0)
  finally:
    storage.close()
  with open(target, 'rb') as f:
    check(f.read() == payload, '24e: the downloaded bytes differ')
  check(token == 'tok-sa', '24e: the grant gave no token')
  check(storage.requests[-1][2].get('authorization') == 'Bearer tok-sa',
        '24e: the media GET carried no Bearer token')
  print(f'24e GCS download over loopback: RS256 JWT with an RSA-2048 key '
        f'signed in {sign_ms:.3f} ms (mean of '
        f'10), JWT-bearer grant {grant_ms:.2f} ms, {GCS_OBJECT_MB} MB media '
        f'download with the Bearer token {download_ms:.2f} ms '
        f'({GCS_OBJECT_MB / download_ms * 1e3:.1f} MB/s), bytes equal',
        flush=True)
  out['gcs'] = dict(sign_ms=sign_ms, grant_ms=grant_ms,
                    download_ms=download_ms, mb=GCS_OBJECT_MB)
  return out


# Phase 27: SavedModels of TF ops (jax2tf's pre-native graphs, the `xla`
# and `plain` modes) and dict observations. Tolerances (rtol, atol) of the
# committed fixtures against TF's recorded outputs: tests/test_torch_tf_
# graphs.py's (the JAX test's for the UNets, 1e-5 for the others).
TF_GRAPH_FIXTURES = os.path.join(ROOT, 'tests', 'data', 'torch_tf_graphs')
TF_GRAPH_TOLERANCES = {'ppo_v3_2s': (1e-5, 1e-5),
                       'actor_critic': (1e-5, 1e-5),
                       'rate_predictor': (1e-5, 1e-6),
                       'atom_detector': (1e-3, 1e-4),
                       'image_aligner': (1e-3, 1e-4)}
# 27c: tiny_eval's ten seeds at the 128^2 render, each episode cut at this
# many steps (the narrow actor-critic is untrained: its episodes run to the
# step limit).
TF_GRAPH_PIXEL_STEPS = 40


def tf_graphs(dev, smi, path_launches) -> dict:
  """Phase 27 (see the module docstring); returns the numbers it read."""
  import torch

  recorded = {}
  with _recording_inputs(recorded):
    out = _tf_graphs(dev, smi, path_launches)
  gen = torch.Generator(device=dev).manual_seed(27)
  render = _recorded(recorded, 'clahe_small', (1, 128, 128), '27d')
  kw = {k: render[k] for k in ('clip_limit', 'grid_size', 'nbins')}
  out['twins'] = {
      'noise_chain_128': _hold_noise_chain(
          dev, _recorded(recorded, 'noise_chain', (1, 128, 128), '27d'),
          "27d on the pixel host eval's clean renders:", gen),
      'clahe_small_128': _hold_clahe_small(
          render['image'], kw, "27d clahe_small (1, 128, 128) on the pixel "
          "host eval's frames"),
  }
  return out


def _tf_graphs(dev, smi, path_launches) -> dict:
  import numpy as np
  import torch

  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.io import tf_export
  from putting_dune_torch.ops import _build

  out = {}
  with open(os.path.join(TF_GRAPH_FIXTURES, 'index.json')) as f:
    index = json.load(f)

  # -- 27a. every committed fixture on the card -------------------------------
  for name, entry in sorted(index['fixtures'].items()):
    root = os.path.join(TF_GRAPH_FIXTURES, name)
    if entry['inputs']:
      x = {k: np.load(os.path.join(root, f'input_{k}.npy'))
           for k in entry['inputs']}
    else:
      x = np.load(os.path.join(root, 'input.npy'))
    t0 = time.perf_counter()
    model = tf_export.load_tf_saved_model(os.path.join(root, 'saved_model'),
                                          device=dev)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = model(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = got if isinstance(got, tuple) else (got,)
    rtol, atol = TF_GRAPH_TOLERANCES[name.rsplit('_', 1)[0]]
    worst = 0.0
    for i, g in enumerate(got):
      check(g.device.type == dev.type, f'27a: {name} output on {g.device}')
      want = np.load(os.path.join(root, f'output_{i}.npy'))
      g = g.cpu().numpy()
      check(bool(np.allclose(g, want, rtol=rtol, atol=atol)),
            f'27a: {name} differs from TF\'s recorded output')
      worst = max(worst, float(np.abs(g - want).max()))
    forward_ms = time_ms(lambda: model(x), repeats=20)
    print(f'27a {name} ({len(entry["ops"])} op types) on the card: load '
          f'{load_s:.3f} s, first call {first_s:.3f} s, forward '
          f'{forward_ms:.3f} ms (median of 20, host inputs), max|d| '
          f'{worst:.3g} against TF\'s recorded output (rtol {rtol:g}, atol '
          f'{atol:g}) on {smi}', flush=True)
    out[name] = dict(max_abs_err=worst, load_s=load_s, first_s=first_s,
                     forward_ms=forward_ms)

  # -- 27b. the host evaluator through the full-width xla-mode MLP ------------
  experiment = registry.create_eval_experiment('eval_ppo_v3_2s')
  tf_agent = eval_agent.TfSavedModelAgent(
      os.path.join(TF_GRAPH_FIXTURES, 'ppo_v3_2s_xla', 'saved_model'),
      device=dev)
  native_agent = eval_agent.EvalAgent.load(
      os.path.join(eval_agent.MODEL_WEIGHTS_DIR, '230422_ppo_v3_2s'), dev)
  diffs = []

  class Paired:
    """Acts with the SavedModel agent; holds each action to EvalAgent's."""

    def step(self, time_step):
      action = tf_agent.step(time_step)
      diffs.append(float(np.abs(action - native_agent.step(time_step)).max()))
      return action

    def set_mode(self, mode):
      tf_agent.set_mode(mode)
      native_agent.set_mode(mode)

  env = run_helpers.create_putting_dune_env(
      0, experiment.get_adapters_and_goal, experiment.get_simulator_config,
      simulator_step_limit=SAVED_MODEL_EPISODE_STEPS, device=dev)
  t0 = time.perf_counter()
  (result,) = eval_lib.evaluate(Paired(), env, [0])
  episode_s = time.perf_counter() - t0
  check(len(diffs) == result.num_actions_taken and diffs,
        '27b: the evaluator took no action')
  print(f'27b host evaluator, eval_ppo_v3_2s seed 0 through '
        f'TfSavedModelAgent on the xla-mode graph (hidden (256, 256)): '
        f'{result.num_actions_taken} actions in {episode_s:.2f} s, each '
        f'against EvalAgent on the shipped checkpoint: max|d| '
        f'{max(diffs):.3g} (bar 1e-5)', flush=True)
  check(max(diffs) <= 1e-5, '27b: TfSavedModelAgent differs from EvalAgent')
  out['episode'] = dict(actions=result.num_actions_taken,
                        max_abs_err=max(diffs), seconds=episode_s)

  # -- 27c. a host pixel eval through the narrow actor-critic (dict obs) -------
  experiment = registry.create_eval_experiment('ppo_simple_images_tf')
  seeds = eval_lib.EVAL_SUITES['tiny_eval']
  for mode in ('xla', 'plain'):
    agent = eval_agent.TfSavedModelAgent(
        os.path.join(TF_GRAPH_FIXTURES, f'actor_critic_{mode}',
                     'saved_model'), device=dev)
    env = run_helpers.create_putting_dune_env(
        0, experiment.get_adapters_and_goal, experiment.get_simulator_config,
        simulator_step_limit=TF_GRAPH_PIXEL_STEPS, image_size=128,
        device=dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    results = eval_lib.evaluate(agent, env, seeds)
    seconds = time.perf_counter() - t0
    counted = dict(_build.LAUNCHES)
    steps = sum(r.num_actions_taken for r in results)
    print(f'27c host pixel eval, tiny_eval at the 128^2 render, the '
          f'{mode}-mode actor-critic on the dict observation: {steps} env '
          f'steps in {seconds:.2f} s = {steps / seconds:.1f} env steps/s at '
          f'batch 1 on {smi}; launches {counted}', flush=True)
    check(steps > 0, '27c: the evaluator took no action')
    # One render a step plus one a reset: noise_chain and clahe_small.
    for kernel in ('noise_chain', 'clahe_small'):
      check(counted[kernel] == steps + len(seeds),
            f'27c: {kernel} not launched once a render')
    path_launches[f'tf_graph_pixel_128_{mode}'] = counted
    out[f'pixel_eval_{mode}'] = dict(steps=steps, seconds=seconds,
                                     launches=counted)
  return out


def main() -> None:
  import torch

  if not torch.cuda.is_available():
    print('FAIL: torch.cuda.is_available() is false', flush=True)
    sys.exit(2)
  t_smoke = time.perf_counter()
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
  for name in ('noise_chain', 'clahe_remap'):
    for line in sass_summary(str(_build.library_path(name)),
                             _build.nvcc_path()):
      print(f'  sass {name}: {line}', flush=True)

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

  def hold_philox(frames_in, packed_in, seeds_in, got_out):
    """Philox mode element-wise: the twin on the draws that
    `draws_from_seeds` derives from the same seeds."""
    shape = tuple(frames_in.shape)
    want_out = noise_fused.noise_chain_reference(
        frames_in, packed_in,
        draws=noise_fused.draws_from_seeds(seeds_in, *shape, dev))
    torch.cuda.synchronize()
    err = float((got_out - want_out).abs().max())
    differ = int((got_out != want_out).sum())
    print(f'noise_chain philox draws {shape} against the twin fed '
          f'draws_from_seeds: max|d| = {err:.3g}, {differ} of '
          f'{got_out.numel()} pixels differ', flush=True)
    check(differ <= 1e-5 * got_out.numel(),
          f'noise_chain philox mode disagrees with its twin at {shape}')
    return err

  philox_err = hold_philox(clean, packed, seeds, philox)
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
  _, exact_mapping = clahe_fused.hist_lut_order_exact(philox)
  torch.cuda.synchronize()
  map_err = float((mapping - want_mapping).abs().max())
  exact_err = float((mapping - exact_mapping).abs().max())
  clahe_err = float((out - want_out).abs().max())
  remap_err = float((out - clahe_fused.remap_reference(philox, mapping))
                    .abs().max())
  print(f'clahe: histograms equal, mapping max|d| = {map_err:.3g} '
        f'(against the order-exact version {exact_err:.3g}), output max|d| '
        f'= {clahe_err:.3g} (remap alone {remap_err:.3g})', flush=True)
  check(clahe_err <= 2e-5 and map_err <= 2e-5, 'clahe disagrees with twin')
  check(exact_err == 0.0,
        'clahe_hist_lut mapping differs from the order-exact version')
  del want_out, want_hist, want_mapping, exact_mapping

  # -- 5. timing -----------------------------------------------------------
  rows = {}
  t_noise = time_ms(lambda: noise_fused.noise_chain(clean, packed,
                                                    seeds=seeds))
  t_noise_plain = time_ms(lambda: noise_fused.noise_chain_reference(
      clean, packed, gen=gen), repeats=20)
  nb_512 = noise_bound(clean, packed)
  print(f"noise_chain (100, 512, 512) bounds: bytes "
        f"{nb_512['bytes_bound_ms']:.4f} ms, operations "
        f"{nb_512['operations_bound_ms']:.4f} ms (lambda < 4 on "
        f"{nb_512['small_lambda_share']:.3f} of the pixels); philox mode "
        f"max|d| {philox_err:.3g}", flush=True)
  rows['noise_chain'] = (t_noise, t_noise_plain, noise_err,
                         nb_512['bound_ms'], nb_512['bound_by'],
                         SOURCES['noise_chain'])
  t_hist = time_ms(lambda: clahe_fused.clahe_hist_lut(philox))
  # Device time alone (CUPTI), beside the per-call time, which holds the
  # wrapper's host time.
  device = {
      'clahe_hist_lut': device_ms(lambda: clahe_fused.clahe_hist_lut(philox),
                                  KERNEL_NAMES['clahe_hist_lut']),
      'noise_chain': device_ms(
          lambda: noise_fused.noise_chain(clean, packed, seeds=seeds),
          KERNEL_NAMES['noise_chain']),
  }
  t_hist_plain = time_ms(lambda: clahe_fused.hist_lut_reference(philox),
                         repeats=20)
  rows['clahe_hist_lut'] = (t_hist, t_hist_plain, map_err,
                            *bound(4.0 * npx + hist.numel() * 8,
                                   HIST_OPS_PER_PIXEL * npx),
                            SOURCES['clahe_hist_lut'])
  t_remap = time_ms(lambda: clahe_fused.clahe_remap(philox, mapping))
  device['clahe_remap'] = device_ms(
      lambda: clahe_fused.clahe_remap(philox, mapping),
      KERNEL_NAMES['clahe_remap'])
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

  def hold_pair(shape, nbins, grid=8):
    x = frames(shape)
    hist_p, mapping_p = clahe_fused.clahe_hist_lut(x, grid, nbins=nbins)
    out = clahe_fused.clahe_remap(x, mapping_p)
    want_hist, want_mapping = clahe_fused.hist_lut_reference(
        x, grid, nbins=nbins)
    _, exact = clahe_fused.hist_lut_order_exact(x, grid, nbins=nbins)
    want = clahe_fused.clahe_reference(x, grid_size=grid, nbins=nbins)
    torch.cuda.synchronize()
    errs = (float((mapping_p - want_mapping).abs().max()),
            float((out - clahe_fused.remap_reference(x, mapping_p))
                  .abs().max()),
            float((out - want).abs().max()))
    exact_err = float((mapping_p - exact).abs().max())
    print(f'clahe pair {shape} nbins {nbins} grid {grid}: histograms '
          f'{"equal" if torch.equal(hist_p, want_hist) else "DIFFER"}, '
          f'mapping max|d| = {errs[0]:.3g} (against the order-exact version '
          f'{exact_err:.3g}), remap max|d| = {errs[1]:.3g}, output max|d| = '
          f'{errs[2]:.3g}', flush=True)
    check(bool(torch.equal(hist_p, want_hist)),
          f'clahe_hist_lut histograms differ at {shape}')
    check(max(errs) <= 2e-5, f'clahe pair disagrees with twins at {shape}')
    check(exact_err == 0.0, f'clahe_hist_lut mapping differs from the '
          f'order-exact version at {shape}, {nbins} bins, grid {grid}')
    return x, mapping_p, errs

  x_small, small_err = hold_small((256, 128, 128), 256)
  hold_small((64, 128, 128), 128)
  x8 = frames((8, 128, 128))
  s_out, s_hist = clahe_fused.clahe_small(x8, return_hist=True)
  p_hist, p_map = clahe_fused.clahe_hist_lut(x8)
  route_err = float((s_out - clahe_fused.clahe_remap(x8, p_map)).abs().max())
  print(f'clahe_small vs split pair (8, 128, 128): max|d| = {route_err:.3g}',
        flush=True)
  check(bool(torch.equal(s_hist, p_hist)) and route_err == 0.0,
        'clahe_small and the split pair differ')
  x_mid, map_mid, mid_errs = hold_pair((128, 256, 256), 256)
  hold_pair((64, 384, 384), 256)
  x_v128, map_v128, v128_errs = hold_pair((64, 128, 128), 128)
  hold_pair((16, 240, 360), 256, grid=6)
  hold_pair((4, 264, 328), 256)  # tiles 33 x 41: one float a lane
  hold_pair((8, 256, 256), 100)
  hold_pair((2, 256, 256), 1024, grid=4)

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
  seeds_mid = torch.randint(0, 2**62, (nb,), generator=gen, device=dev)
  hold_philox(x_mid, packed_mid, seeds_mid,
              noise_fused.noise_chain(x_mid, packed_mid, seeds=seeds_mid))
  # 200 rows over the blocks of a frame leave the last block short.
  x_odd = frames((3, 200, 328))
  packed_odd = packed_mid[:3].contiguous()
  draws_odd = noise_fused.sample_draws(gen, 3, 200, 328, dev)
  noise_odd_err = float((
      noise_fused.noise_chain(x_odd, packed_odd, draws=draws_odd)
      - noise_fused.noise_chain_reference(x_odd, packed_odd, draws=draws_odd)
  ).abs().max())
  print(f'noise_chain injected draws (3, 200, 328): max|d| = '
        f'{noise_odd_err:.3g}', flush=True)
  check(noise_odd_err <= 1e-5,
        'noise_chain disagrees with its twin at (3, 200, 328)')
  del draws_odd, x_odd

  # noise_chain at the 256^2 render of the multi-dopant loop: four clean
  # batches in turn (26 MB each, 105 MB together, above the 50 MB L2).
  noise_inputs = [frames((100, 256, 256)) for _ in range(4)]
  packed_100 = packed_mid[:100].contiguous()
  seeds_100 = seeds_mid[:100].contiguous()
  t_noise_mid = time_rotating_ms(
      lambda x: noise_fused.noise_chain(x, packed_100, seeds=seeds_100),
      noise_inputs)
  d_noise_mid = device_ms(
      rotating(lambda x: noise_fused.noise_chain(x, packed_100,
                                                 seeds=seeds_100),
               noise_inputs), KERNEL_NAMES['noise_chain'])
  t_noise_mid_plain = time_ms(lambda: noise_fused.noise_chain_reference(
      noise_inputs[0], packed_100, gen=gen), repeats=10)
  nb_256 = noise_bound(noise_inputs[0], packed_100)
  other_shapes['noise_chain'].append({
      'shape': [100, 256, 256], 'ms': t_noise_mid,
      'plain_ms': t_noise_mid_plain, 'bound_ms': nb_256['bound_ms'],
      'bound_by': nb_256['bound_by'],
      'bytes_bound_ms': nb_256['bytes_bound_ms'],
      'operations_bound_ms': nb_256['operations_bound_ms'],
      'max_abs_err': noise_mid_err, 'device_ms': d_noise_mid})
  del noise_inputs

  # Times: four buffers in turn (67 MB and 134 MB of frames, above the
  # 50 MB L2), and the same launch on one buffer for the L2-warm time.
  small_inputs = [x_small] + [frames((256, 128, 128)) for _ in range(3)]
  t_small = time_rotating_ms(clahe_fused.clahe_small, small_inputs)
  device['clahe_small'] = device_ms(
      rotating(clahe_fused.clahe_small, small_inputs),
      KERNEL_NAMES['clahe_small'])
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
  print(f'clahe_small (256, 128, 128): {t_small:.4f} ms (device '
        f"{fmt_ms(device['clahe_small'])}; {t_small_warm:.4f} ms on one "
        f'L2-resident buffer); split pair at the same shape '
        f'{t_pair_at_small:.4f} ms', flush=True)
  del small_inputs

  mid_inputs = [x_mid] + [frames((128, 256, 256)) for _ in range(3)]
  n_mid = x_mid.numel()
  t_hist_mid = time_rotating_ms(clahe_fused.clahe_hist_lut, mid_inputs)
  d_hist_mid = device_ms(rotating(clahe_fused.clahe_hist_lut, mid_inputs),
                         KERNEL_NAMES['clahe_hist_lut'])
  t_remap_mid = time_rotating_ms(
      lambda x: clahe_fused.clahe_remap(x, map_mid), mid_inputs)
  d_remap_mid = device_ms(
      rotating(lambda x: clahe_fused.clahe_remap(x, map_mid), mid_inputs),
      KERNEL_NAMES['clahe_remap'])
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
  other_shapes['clahe_hist_lut'][-1]['device_ms'] = d_hist_mid
  other_shapes['clahe_remap'][-1]['device_ms'] = d_remap_mid
  # The any-`nbins` histogram branch at 128 bins (4 MB of frames: they stay
  # in L2 whatever the rotation).
  v128_inputs = [x_v128] + [frames((64, 128, 128)) for _ in range(3)]
  t_hist_v128 = time_rotating_ms(
      lambda x: clahe_fused.clahe_hist_lut(x, nbins=128), v128_inputs)
  d_hist_v128 = device_ms(
      rotating(lambda x: clahe_fused.clahe_hist_lut(x, nbins=128),
               v128_inputs), KERNEL_NAMES['clahe_hist_lut'])
  v128_bound, v128_by = bound(
      4.0 * x_v128.numel() + map_v128.numel() * 8,
      HIST_OPS_PER_PIXEL * x_v128.numel())
  other_shapes['clahe_hist_lut'].append({
      'shape': [64, 128, 128], 'nbins': 128, 'ms': t_hist_v128,
      'plain_ms': time_ms(
          lambda: clahe_fused.hist_lut_reference(x_v128, nbins=128),
          repeats=20),
      'bound_ms': v128_bound, 'bound_by': v128_by,
      'max_abs_err': v128_errs[0], 'device_ms': d_hist_v128})
  del v128_inputs, x_v128, map_v128
  pair_bound, _ = bound(8.0 * n_mid, 0)
  print(f'clahe pair (128, 256, 256): hist_lut {t_hist_mid:.4f} ms (device '
        f'{fmt_ms(d_hist_mid)}) + remap {t_remap_mid:.4f} ms, both in turn '
        f'{t_pair_mid:.4f} ms (bound of the whole, frame read once and '
        f'written once: {pair_bound:.4f} ms)', flush=True)
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
    # One warm call first, so that the timed one pays no first-use cost.
    t0 = time.perf_counter()
    det_data.sample_batch(gen, lat, batch_size=64, image_size=size,
                          noisy=True)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
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
    print(f'path A sample_batch 64 x {size}^2 noisy: {seconds * 1e3:.1f} ms '
          f'warm (first call {first * 1e3:.1f} ms), launches {counted}',
          flush=True)
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
  def run_eval(name, bar, suite='small_eval', path='path B'):
    _build.reset_launches()
    torch.cuda.synchronize()
    rep = eval_cli.main(eval_cli.Args(
        experiment_name=name, eval_suite=suite, device='cuda'))
    torch.cuda.synchronize()
    counted = dict(_build.LAUNCHES)
    a = rep['aggregate']
    print(f"{path} {name} {suite}: success "
          f"{a['average_num_times_reached_goal']}, average actions "
          f"{a['average_num_actions_taken']:.2f}, {rep['env_steps']} env "
          f"steps in {rep['wall_seconds']:.2f} s = "
          f"{rep['env_steps'] / rep['wall_seconds']:.1f} env steps/s, "
          f"launches {counted}", flush=True)
    check(a['average_num_times_reached_goal'] >= bar,
          f'{name} success below {bar}')
    eval_success[name] = a['average_num_times_reached_goal']
    eval_reports[name] = rep
    return counted

  eval_success, eval_reports = {}, {}

  counted = run_eval('vision_planner_simple_rates', 0.90)
  path_launches['vision_planner_512'] = counted
  for name in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
    check(counted[name] > 0, f'{name} was not launched on path B')
  run_eval('planner_simple_rates', 0.95)

  # -- 11. splat_render on the multi-dopant env's atom windows -----------------
  from putting_dune_torch.imaging import clahe as clahe_lib
  from putting_dune_torch.imaging import render as render_lib
  from putting_dune_torch.ops import clahe_interp
  from putting_dune_torch.ops import splat as splat_lib

  md_exp = registry.create_multi_dopant_experiment(
      'multi_dopant_3_vision_planner')
  md_env = md_exp.make_env(100, device=dev)
  md_gen = env_lib.make_generator(3, dev)
  md_state, _ = md_env.reset(md_gen)
  md_window = md_env._atom_window(md_state)
  md_fov = md_env._fov(md_state)
  check(tuple(md_window.positions.shape) == (100, 512, 2), 'atom window shape')

  def default_splat(bx, by, wts, sx, sy, size):
    gx = render_lib._splat_axis_kernels(bx, sx, size)
    gy = render_lib._splat_axis_kernels(by, sy, size) * wts[..., None]
    image = torch.flip(torch.bmm(gy.transpose(1, 2), gx), dims=(-2,))
    peak = torch.amax(image, dim=(-2, -1), keepdim=True)
    return image / torch.clamp(peak, min=1e-20)

  splat_rows, clean_md = {}, {}
  for size in (256, 512):
    operands = [t.contiguous() for t in render_lib._splat_inputs(
        md_window, md_fov, md_state.imaging.intensity_exponent, size,
        md_state.imaging.blur_amount)]
    bx, by, wts, sx, sy = operands
    got = splat_lib.splat_render(*operands, image_size=size)
    want = splat_lib.splat_render_reference(*operands, image_size=size)
    route = default_splat(*operands, size)
    exact = splat_lib.splat_render_atom_order(*operands, image_size=size)
    torch.cuda.synchronize()
    err_twin = float((got - want).abs().max())
    err_route = float((got - route).abs().max())
    err_exact = float((got - exact).abs().max())
    real = int((wts > 0).sum())
    print(f'splat_render (100, 512, {size}): {real} real atoms, max|d| vs twin '
          f'= {err_twin:.3g}, vs the default route = {err_route:.3g}, vs the '
          f'atom-order version = {err_exact:.3g}', flush=True)
    check(bool(torch.isfinite(got).all()) and float(got.amax()) == 1.0,
          'splat_render frames are not max-normalized')
    check(err_twin <= 1e-5, f'splat_render disagrees with its twin at {size}')
    check(err_route <= 1e-5,
          f'splat_render disagrees with the default route at {size}')
    check(err_exact == 0.0,
          f'splat_render differs from the atom-order version at {size}')
    del exact
    del want, route
    # Work this run's data needs: two operations per (real atom, pixel of
    # its truncated support); the dense contraction is given beside it.
    support = ((2 * torch.floor(4 * sx + 0.5) + 1)
               * (2 * torch.floor(4 * sy + 0.5) + 1))  # (B,)
    sparse_ops = 2.0 * float(((wts > 0).sum(dim=1) * support).sum())
    dense_ops = 2.0 * 100 * 512 * size * size
    nbytes = 4.0 * (got.numel() + 3 * bx.numel() + 2 * sx.numel())
    bound_ms, bound_by = bound(nbytes, sparse_ops)
    t_kernel = time_ms(lambda: splat_lib.splat_render(
        *operands, image_size=size))
    d_kernel = device_ms(lambda: splat_lib.splat_render(
        *operands, image_size=size), KERNEL_NAMES['splat_render'])
    t_twin = time_ms(lambda: splat_lib.splat_render_reference(
        *operands, image_size=size), repeats=10)
    t_route = time_ms(lambda: default_splat(*operands, size), repeats=10)
    print(f'splat_render (100, 512, {size}): {t_kernel:.4f} ms (device '
          f'{fmt_ms(d_kernel)}), twin {t_twin:.4f} ms, default route '
          f'{t_route:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); dense '
          f'contraction {dense_ops / F32_OPS_PER_S * 1e3:.4f} ms', flush=True)
    splat_rows[size] = {
        'shape': [100, 512, size], 'ms': t_kernel, 'device_ms': d_kernel,
        'plain_ms': t_twin, 'bound_ms': bound_ms, 'bound_by': bound_by,
        'max_abs_err': err_twin, 'atom_order_max_abs_err': err_exact,
        'library_ms': t_route,
        'dense_contraction_ms': dense_ops / F32_OPS_PER_S * 1e3}
    clean_md[size] = got
  # Small shapes, bit-equal to the atom-order version: one frame of 77
  # atoms (not a multiple of 32) at S = 200, and widths whose radius (~38
  # rows) is above a block's band of 8 rows at S = 128.
  for b_s, k_s, s_s, scale in ((1, 77, 200, 1.0), (4, 64, 128, 8.0)):
    small_ops = [t[:b_s, :k_s].contiguous() for t in operands[:3]] + [
        (t[:b_s] * (s_s / size) * scale).contiguous() for t in operands[3:]]
    small_ops[:2] = [torch.clamp(t * (s_s / size), max=s_s - 1).floor()
                     for t in small_ops[:2]]
    got_s = splat_lib.splat_render(*small_ops, image_size=s_s)
    err_s = float((got_s - splat_lib.splat_render_atom_order(
        *small_ops, image_size=s_s)).abs().max())
    radius = float(torch.floor(4 * small_ops[4] + 0.5).max())
    print(f'splat_render ({b_s}, {k_s}, {s_s}), radius up to {radius:.0f} '
          f'rows: max|d| vs the atom-order version = {err_s:.3g}', flush=True)
    check(err_s == 0.0, f'splat_render differs from the atom-order version '
          f'at {(b_s, k_s, s_s)}')
  row = splat_rows[256]
  rows['splat_render'] = (row['ms'], row['plain_ms'], row['max_abs_err'],
                          row['bound_ms'], row['bound_by'],
                          SOURCES['splat_render'])
  device['splat_render'] = row['device_ms']
  shapes['splat_render'] = (100, 512, 256)
  # No single PyTorch call computes the splat; its yardstick is the default
  # route (two (B, K, S) exp passes and `torch.bmm`), what a caller who does
  # not ask for the fused backend runs.
  library = {'splat_render': row['library_ms']}
  other_shapes['splat_render'].append(splat_rows[512])

  # -- 12. clahe_interp on that env's noisy frames ------------------------------
  md_packed = noise_fused.pack_params(md_state.imaging, 100)
  noisy = {size: noise_fused.noise_chain(clean, md_packed, gen=md_gen)
           for size, clean in clean_md.items()}
  del clean_md
  interp_rows = {}
  for size, nbins in ((256, 256), (512, 256), (256, 128)):
    frames_n = noisy[size]
    blocks, luts, wgt = clahe_lib.dual_block_inputs(frames_n, nbins=nbins)
    check(tuple(blocks.shape) == (100, 81, (size // 8) ** 2)
          and tuple(luts.shape) == (100, 81, nbins, 4), 'dual block shapes')
    got = clahe_interp.clahe_interpolate(blocks, luts, wgt)
    want = clahe_interp.clahe_interpolate_reference(blocks, luts, wgt)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    whole = clahe_lib.equalize_adapthist(frames_n, nbins=nbins,
                                         backend='interp')
    default = clahe_lib.equalize_adapthist(frames_n, nbins=nbins)
    torch.cuda.synchronize()
    err_route = float((whole - default).abs().max())
    print(f'clahe_interp {tuple(blocks.shape)} nbins {nbins}: max|d| vs twin '
          f'= {err:.3g}; whole interpolation route vs the default route at '
          f'(100, {size}, {size}): max|d| = {err_route:.3g}', flush=True)
    check(err <= 1e-6, f'clahe_interp disagrees with its twin at {size}')
    check(err_route <= 2e-5,
          f'the interpolation route disagrees with the default at {size}')
    del want, whole, default
    if nbins != 256:
      continue
    nbytes = 4.0 * (blocks.numel() + luts.numel() + wgt.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, INTERP_OPS_PER_PIXEL * blocks.numel())
    t_kernel = time_ms(lambda: clahe_interp.clahe_interpolate(
        blocks, luts, wgt))
    d_kernel = device_ms(lambda: clahe_interp.clahe_interpolate(
        blocks, luts, wgt), KERNEL_NAMES['clahe_interp'])
    t_twin = time_ms(lambda: clahe_interp.clahe_interpolate_reference(
        blocks, luts, wgt), repeats=10)
    _, map_n = clahe_fused.clahe_hist_lut(frames_n)
    t_remap_n = time_ms(lambda: clahe_fused.clahe_remap(frames_n, map_n))
    t_whole = time_ms(lambda: clahe_lib.equalize_adapthist(
        frames_n, backend='interp'), repeats=10)
    t_default = time_ms(lambda: clahe_lib.equalize_adapthist(frames_n),
                        repeats=10)
    print(f'clahe_interp {tuple(blocks.shape)}: {t_kernel:.4f} ms (device '
          f'{fmt_ms(d_kernel)}), twin {t_twin:.4f} ms, bound {bound_ms:.4f} '
          f'ms ({bound_by}); '
          f'clahe_remap on the same frames {t_remap_n:.4f} ms; whole '
          f'interpolation route {t_whole:.4f} ms, default route '
          f'{t_default:.4f} ms', flush=True)
    interp_rows[size] = {
        'shape': list(blocks.shape), 'ms': t_kernel, 'device_ms': d_kernel,
        'plain_ms': t_twin, 'bound_ms': bound_ms, 'bound_by': bound_by,
        'max_abs_err': err, 'clahe_remap_ms': t_remap_n,
        'whole_route_ms': t_whole, 'default_route_ms': t_default}
    del map_n
  del blocks, luts, wgt, got, noisy
  row = interp_rows[256]
  rows['clahe_interp'] = (row['ms'], row['plain_ms'], row['max_abs_err'],
                          row['bound_ms'], row['bound_by'],
                          SOURCES['clahe_interp'])
  shapes['clahe_interp'] = tuple(row['shape'])
  device['clahe_interp'] = row['device_ms']
  other_shapes['clahe_interp'].append(interp_rows[512])
  torch.cuda.empty_cache()

  # -- 13. path C: the two kernels through the imaging API, to actions ----------
  md_agent = md_exp.get_agent(dev)
  _build.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  md_state, md_ts = md_env.reset(md_gen)
  md_window = md_env._atom_window(md_state)
  md_fov = md_env._fov(md_state)
  clean_c = render_lib.render_clean_image(
      md_window, md_fov, md_state.imaging.intensity_exponent, image_size=256,
      blur_amount=md_state.imaging.blur_amount, backend='fused')
  noisy_c = noise_fused.noise_chain(
      clean_c, noise_fused.pack_params(md_state.imaging, 100), gen=md_gen)
  frames_c = clahe_lib.equalize_adapthist(noisy_c, clip_limit=0.01,
                                          backend='interp')
  obs_c = dict(md_ts.observation, image=frames_c[..., None])
  policy_c = md_agent.policy()
  actions_c = torch.clamp(policy_c(md_gen, obs_c), -1.0, 1.0)
  md_state, md_ts = md_env.step(md_state, actions_c, md_gen)
  torch.cuda.synchronize()
  seconds_c = time.perf_counter() - t0
  counted = dict(_build.LAUNCHES)
  path_launches['path_c_multi_dopant_3_256'] = counted
  obs_d = dict(obs_c, image=clahe_lib.equalize_adapthist(
      noisy_c, clip_limit=0.01)[..., None])
  actions_d = torch.clamp(policy_c(md_gen, obs_d), -1.0, 1.0)
  close = int(((actions_c - actions_d).abs().amax(dim=-1) <= 0.05).sum())
  print(f'path C (reset -> fused splat -> noise_chain -> interpolation route '
        f'-> UNet -> multi-dopant vision policy -> step): {seconds_c:.2f} s, '
        f'{close} of 100 actions within 0.05 of the default CLAHE route\'s, '
        f'launches {counted}', flush=True)
  check(tuple(actions_c.shape) == (100, 2)
        and bool(torch.isfinite(actions_c).all())
        and float(actions_c.abs().max()) <= 1.0, 'path C actions')
  check(close >= 99, 'path C actions differ from the default CLAHE route')
  check(bool(torch.isfinite(md_ts.observation['image']).all())
        and bool(torch.isfinite(md_ts.reward).all()), 'path C env step')
  for name in ('splat_render', 'clahe_interp', 'noise_chain'):
    check(counted[name] > 0, f'{name} was not launched on path C')
  del md_env, md_state, md_ts, md_agent, policy_c, obs_c, obs_d, noisy_c
  torch.cuda.empty_cache()

  # -- 14. path A: the multi-dopant control loop on vector observations ---------
  path_launches['multi_dopant_3_planner'] = run_eval(
      'multi_dopant_3_planner', 0.95, path='path A')
  run_eval('multi_dopant_2_distilled', 0.75, suite='tiny_eval', path='path A')

  # -- 15. path B: the multi-dopant perception loop ------------------------------
  counted = run_eval('multi_dopant_3_vision_planner',
                     MULTI_DOPANT_VISION_SUCCESS_BAR)
  path_launches['multi_dopant_3_vision_planner_256'] = counted
  for name in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
    check(counted[name] > 0,
          f'{name} was not launched on the multi-dopant path B')
  for name in ('splat_render', 'clahe_interp', 'clahe_small'):
    check(counted[name] == 0, f'{name} launched on a default route')

  # -- 16. instrument drift ----------------------------------------------------
  run_eval('planner_simple_drift', 0.0, path='drift')
  run_eval('ppo_simple_drift', 0.5, path='drift')
  for name, key in (('vision_planner_drift', 'vision_planner_drift_512'),
                    ('vision_planner_drift_corrected',
                     'vision_planner_drift_corrected_512'),
                    ('multi_dopant_2_vision_planner_drift',
                     'multi_dopant_2_vision_planner_drift_256'),
                    ('multi_dopant_2_vision_planner_drift_corrected',
                     'multi_dopant_2_vision_planner_drift_corrected_256')):
    counted = run_eval(name, DRIFT_SUCCESS_BARS.get(name, 0.0), path='drift')
    path_launches[key] = counted
    for kernel in ('noise_chain', 'clahe_hist_lut', 'clahe_remap'):
      check(counted[kernel] > 0, f'{kernel} was not launched on {name}')
    for kernel in ('splat_render', 'clahe_interp', 'clahe_small'):
      check(counted[kernel] == 0, f'{kernel} launched on a default route')
  check(eval_success['multi_dopant_2_vision_planner_drift_corrected']
        > eval_success['multi_dopant_2_vision_planner_drift'],
        'the drift corrector does not raise the multi-dopant success')

  # -- 17. the rate stack --------------------------------------------------------
  summary = rate_stack(dev, run_eval, eval_reports, path_launches)
  print(f'rate stack summary: {json.dumps(summary)}', flush=True)

  # -- 18. training -------------------------------------------------------------
  t0 = time.perf_counter()
  summary = training(dev, eval_reports, path_launches)
  print(f'training summary ({time.perf_counter() - t0:.1f} s): '
        f'{json.dumps(summary)}', flush=True)

  # -- 19. the hardware loop ----------------------------------------------------
  t0 = time.perf_counter()
  summary = hardware_loop(dev, smi, path_launches)
  print(f'hardware loop summary ({time.perf_counter() - t0:.1f} s): '
        f'{json.dumps(summary)}', flush=True)

  # -- 20. perception training ---------------------------------------------------
  t0 = time.perf_counter()
  summary = perception_training(dev, smi, path_launches)
  print(f'perception training summary ({time.perf_counter() - t0:.1f} s): '
        f'{json.dumps(summary)}', flush=True)

  import tempfile

  with tempfile.TemporaryDirectory(prefix='smoke_aligned_') as kept:
    aligned = os.path.join(kept, 'aligned.riegeli')
    # -- 21. the data pipeline ----------------------------------------------------
    t0 = time.perf_counter()
    summary = data_pipeline(dev, smi, path_launches,
                            summary.get('detector', {}), keep_aligned=aligned)
    print(f'data pipeline summary ({time.perf_counter() - t0:.1f} s): '
          f'{json.dumps(summary)}', flush=True)

    # -- 22. plots, videos and the mesh at world 1 --------------------------------
    t0 = time.perf_counter()
    summary = plots_and_mesh(dev, smi, path_launches, aligned)
    print(f'plots and mesh summary ({time.perf_counter() - t0:.1f} s): '
          f'{json.dumps(summary)}', flush=True)

    # -- 23. the classical rate learners and JPEG ---------------------------------
    t0 = time.perf_counter()
    summary = classical_learners(dev, smi, aligned)
    print(f'classical learners and JPEG summary ({time.perf_counter() - t0:.1f}'
          f' s): {json.dumps(summary)}', flush=True)

    # -- 24. TF SavedModel interop and the authenticated GCS download ---------
    t0 = time.perf_counter()
    summary = saved_model_interop(dev, smi, path_launches)
    print(f'saved model interop summary ({time.perf_counter() - t0:.1f} s): '
          f'{json.dumps(summary)}', flush=True)

    # -- 25. public names, the learners' sklearn files, gradients ------------
    t0 = time.perf_counter()
    summary = gaps_to_the_jax_package(dev, smi)
    print(f'gaps to the JAX package summary ({time.perf_counter() - t0:.1f} '
          f's): {json.dumps(summary)}', flush=True)

  # -- 26. API parity ------------------------------------------------------------
  t0 = time.perf_counter()
  summary = api_parity(dev, smi, path_launches)
  print(f'API parity summary ({time.perf_counter() - t0:.1f} s): '
        f'{json.dumps(summary)}', flush=True)

  # -- 27. SavedModels of TF ops and dict observations ------------------------
  t0 = time.perf_counter()
  summary = tf_graphs(dev, smi, path_launches)
  print(f'TF-op graphs summary ({time.perf_counter() - t0:.1f} s): '
        f'{json.dumps(summary)}', flush=True)

  print(f'phases 1-27 in {time.perf_counter() - t_smoke:.1f} s on {smi}',
        flush=True)

  # -- 28. kernels line --------------------------------------------------------
  kernels = []
  for name, (ms, plain_ms, err, bound_ms, bound_by, source) in rows.items():
    by_path = {path: counts[name] for path, counts in path_launches.items()}
    total = sum(by_path.values())
    check(total > 0, f'{name} was launched on no main path')
    dev_note = f', device {fmt_ms(device[name])}' if name in device else ''
    print(f'{name}: {ms:.4f} ms{dev_note} (bound {bound_ms:.4f} ms, '
          f'{bound_by}), plain twin {plain_ms:.4f} ms, launches {by_path}, at '
          f'{shapes[name]} on {smi}', flush=True)
    for extra in other_shapes[name]:
      extra_dev = (f", device {fmt_ms(extra['device_ms'])}"
                   if 'device_ms' in extra else '')
      print(f"{name}: {extra['ms']:.4f} ms{extra_dev} (bound "
            f"{extra['bound_ms']:.4f} ms, {extra['bound_by']}), plain twin "
            f"{extra['plain_ms']:.4f} ms, at {tuple(extra['shape'])} on {smi}",
            flush=True)
    kernels.append({
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': TPU_SITES[name], 'launches': total,
        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': library.get(name),
        'shape': list(shapes[name]), 'launches_by_path': by_path,
        'other_shapes': other_shapes[name],
    })
    if name in device:
      kernels[-1]['device_ms'] = device[name]
    if name == 'noise_chain':
      kernels[-1].update(
          bytes_bound_ms=nb_512['bytes_bound_ms'],
          operations_bound_ms=nb_512['operations_bound_ms'],
          philox_max_abs_err=philox_err)
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  main()
