"""Writes the JAX-made TF SavedModels that the port's SavedModel reader and
StableHLO interpreter are held to, on the CPU and on the card (whose
machine has neither JAX nor TensorFlow).

  python scripts/make_saved_model_fixtures.py [--out_dir=tests/data]

`torch_saved_models/<name>/` holds, for each of

  * `mlp_policy`: the JAX package's MLPPolicy (32, 32), action_dim 2, on a
    (10,) observation (input `input`);
  * `rate_predictor`: a two-model LearnedRatePredictor (16, 16) through
    its `export_tf` (input `beam_position`, (1, 4));
  * `atom_detector`: the UNet at features (4, 8) on (1, 32, 32, 1)
    (input `image`);
  * `image_aligner`: the GlobalLocalUNet at features (4, 8) on
    (1, 32, 32, 3), returning (local, global) (input `image`),

`saved_model/` (what `putting_dune_tpu.io.tf_export.export_tf_saved_model`
writes; `fingerprint.pb` dropped), `input.npy` (a seeded draw) and
`output_<i>.npy` (what JAX computes on it, jitted, on the CPU); the UNets
also `params.msgpack` (their flax parameters, which the port's exports of
the same weights start from). `versions.json` records the JAX,
TensorFlow, MLIR bytecode and StableHLO versions of the files.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _export(fn, params_bytes, input_shape, input_name, out_dir, seed):
  import jax

  from putting_dune_tpu.io import tf_export

  os.makedirs(out_dir, exist_ok=True)
  save_dir = os.path.join(out_dir, 'saved_model')
  shutil.rmtree(save_dir, ignore_errors=True)
  tf_export.export_tf_saved_model(jax.jit(fn), input_shape, save_dir,
                                  input_name=input_name)
  fingerprint = os.path.join(save_dir, 'fingerprint.pb')
  if os.path.exists(fingerprint):
    os.remove(fingerprint)
  x = np.random.default_rng(seed).standard_normal(input_shape).astype(
      np.float32)
  outs = jax.jit(fn)(x)
  if not isinstance(outs, (tuple, list)):
    outs = (outs,)
  np.save(os.path.join(out_dir, 'input.npy'), x)
  for i, out in enumerate(outs):
    np.save(os.path.join(out_dir, f'output_{i}.npy'), np.asarray(out))
  if params_bytes is not None:
    with open(os.path.join(out_dir, 'params.msgpack'), 'wb') as f:
      f.write(params_bytes)


def make(out_root: str) -> dict:
  import flax
  import jax
  import jax.numpy as jnp

  from putting_dune_tpu.agents import eval_agent
  from putting_dune_tpu.atom_detection import model as det_model
  from putting_dune_tpu.image_alignment import model as align_model
  from putting_dune_tpu.rate_learning import config as rl_config
  from putting_dune_tpu.rate_learning import predictor as predictor_lib

  root = os.path.join(out_root, 'torch_saved_models')
  os.makedirs(root, exist_ok=True)

  mlp = eval_agent.MLPPolicy(hidden=(32, 32), action_dim=2)
  mlp_params = mlp.init(jax.random.PRNGKey(4), jnp.zeros((10,)))['params']
  _export(lambda obs: mlp.apply({'params': mlp_params}, obs), None, (10,),
          'input', os.path.join(root, 'mlp_policy'), 0)

  config = rl_config.RateLearningConfig(num_models=2,
                                        hidden_dimensions=(16, 16))
  predictor = predictor_lib.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(30), config=config)
  out_dir = os.path.join(root, 'rate_predictor')
  os.makedirs(out_dir, exist_ok=True)
  save_dir = os.path.join(out_dir, 'saved_model')
  shutil.rmtree(save_dir, ignore_errors=True)
  predictor.export_tf(save_dir)
  os.remove(os.path.join(save_dir, 'fingerprint.pb'))
  x = np.random.default_rng(1).standard_normal((1, 4)).astype(np.float32)
  np.save(os.path.join(out_dir, 'input.npy'), x)
  np.save(os.path.join(out_dir, 'output_0.npy'),
          np.asarray(predictor.apply_model(jnp.asarray(x))))

  det = det_model.UNet(features=(4, 8))
  det_params = det.init(jax.random.PRNGKey(2),
                        jnp.zeros((1, 32, 32, 1)))['params']
  _export(lambda image: det.apply({'params': det_params}, image),
          flax.serialization.to_bytes(det_params), (1, 32, 32, 1), 'image',
          os.path.join(root, 'atom_detector'), 2)

  frames = 3
  align = align_model.GlobalLocalUNet(
      local_output_size=3 * frames, global_output_size=2 * frames,
      features=(4, 8))
  align_params = align.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, 32, 32, frames)))['params']

  def align_fn(image):
    local, global_out = align.apply({'params': align_params}, image)
    return local, global_out

  _export(align_fn, flax.serialization.to_bytes(align_params),
          (1, 32, 32, frames), 'image', os.path.join(root, 'image_aligner'),
          3)
  return _versions(root)


def _versions(root: str) -> dict:
  import jax
  import tensorflow as tf
  from jaxlib.mlir.dialects import stablehlo

  path = os.path.join(root, 'mlp_policy', 'saved_model', 'saved_model.pb')
  with open(path, 'rb') as f:
    data = f.read()
  start = data.index(b'ML\xefR')
  version = data[start + 4]
  producer = data[start + 5:data.index(b'\0', start + 5)].decode()
  versions = {
      'jax': jax.__version__,
      'tensorflow': tf.__version__,
      'mlir_bytecode': int(version) >> 1,
      'producer': producer,
      'stablehlo_current': stablehlo.get_current_version(),
      'xla_call_module': 10,
  }
  with open(os.path.join(root, 'versions.json'), 'w') as f:
    json.dump(versions, f, indent=1, sort_keys=True)
  return versions


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out_dir', default=os.path.join(REPO, 'tests',
                                                        'data'))
  args = parser.parse_args()
  os.environ.setdefault('JAX_PLATFORMS', 'cpu')
  print(json.dumps(make(args.out_dir), sort_keys=True))


if __name__ == '__main__':
  main()
