"""The UNets through SavedModels both ways, and the `--export_tf` CLIs.

The detector and the aligner at features (4, 8), 32^2, from the committed
fixtures' parameters: the JAX package's export runs here, the port's
loader on it agrees with JAX, and TF on the port's export of the same
weights (the flax -> torch readers) agrees with TF on the JAX export,
within the JAX test's own rtol 1e-3 / atol 1e-4
(tests/test_detection_and_alignment_models.py), with equal signatures and
output structure. Both `save_model --export_tf` CLIs of the port write a
SavedModel that TF and the port load with equal outputs, and print what
the JAX CLIs print.

With gradients (`with_gradient=True` in both packages), TF's
`GradientTape` on the port's export and the port's loader under autograd
equal torch autograd on the native module, and the port's loader on the
JAX export equals TF's gradient on it, within 1e-4 of the largest
gradient.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

tf = pytest.importorskip('tensorflow')
jax = pytest.importorskip('jax')

import flax  # pylint: disable=g-import-not-at-top

from putting_dune_torch.agents import msgpack_reader
from putting_dune_torch.atom_detection import model as t_det_model
from putting_dune_torch.atom_detection import save_model as t_det_save
from putting_dune_torch.atom_detection import train as t_det_train
from putting_dune_torch.image_alignment import model as t_align_model
from putting_dune_torch.image_alignment import save_model as t_align_save
from putting_dune_torch.image_alignment import train as t_align_train
from putting_dune_torch.io import tf_export as t_tf_export
from putting_dune_tpu.atom_detection import model as j_det_model
from putting_dune_tpu.image_alignment import model as j_align_model
from putting_dune_tpu.io import tf_export as j_tf_export
from torch_tf_checks import check
from torch_tf_checks import check_gradients

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore::UserWarning',
                                        'ignore::FutureWarning',
                                        'ignore::DeprecationWarning')

FIXTURES = (pathlib.Path(__file__).resolve().parent / 'data'
            / 'torch_saved_models')


def _fixture_params(name):
  data = (FIXTURES / name / 'params.msgpack').read_bytes()
  return (flax.serialization.msgpack_restore(data),
          msgpack_reader.unpackb(data))


def test_detector_at_small_widths(tmp_path):
  jax_params, flax_tree = _fixture_params('atom_detector')
  module = j_det_model.UNet(features=(4, 8))
  fn = lambda image: module.apply({'params': jax_params}, image)  # noqa: E731
  j_tf_export.export_tf_saved_model(jax.jit(fn), (1, 32, 32, 1),
                                    str(tmp_path / 'jax'), input_name='image')
  port_model = t_det_model.UNet(features=(4, 8))
  port_model.load_state_dict(t_det_model.params_from_flax(flax_tree))
  t_tf_export.export_tf_saved_model(port_model.eval(), (1, 32, 32, 1),
                                    str(tmp_path / 'port'),
                                    input_name='image')
  x = np.random.default_rng(3).standard_normal((1, 32, 32, 1)).astype(
      np.float32)
  check(tmp_path / 'jax', tmp_path / 'port', x, np.asarray(jax.jit(fn)(x)),
         1e-3, 1e-4)


def test_aligner_at_small_widths(tmp_path):
  jax_params, flax_tree = _fixture_params('image_aligner')
  module = j_align_model.GlobalLocalUNet(
      local_output_size=9, global_output_size=6, features=(4, 8))

  def fn(image):
    local, global_out = module.apply({'params': jax_params}, image)
    return local, global_out

  j_tf_export.export_tf_saved_model(jax.jit(fn), (1, 32, 32, 3),
                                    str(tmp_path / 'jax'), input_name='image')
  t_tf_export.export_tf_saved_model(
      t_align_model.from_flax(flax_tree), (1, 32, 32, 3),
      str(tmp_path / 'port'), input_name='image')
  x = np.random.default_rng(4).standard_normal((1, 32, 32, 3)).astype(
      np.float32)
  native = tuple(np.asarray(o) for o in jax.jit(fn)(x))
  check(tmp_path / 'jax', tmp_path / 'port', x, native, 1e-3, 1e-4)


def test_detector_with_gradient(tmp_path):
  jax_params, flax_tree = _fixture_params('atom_detector')
  module = j_det_model.UNet(features=(4, 8))
  fn = lambda image: module.apply({'params': jax_params}, image)  # noqa: E731
  j_tf_export.export_tf_saved_model(jax.jit(fn), (1, 32, 32, 1),
                                    str(tmp_path / 'jax'), input_name='image',
                                    with_gradient=True)
  port_model = t_det_model.UNet(features=(4, 8))
  port_model.load_state_dict(t_det_model.params_from_flax(flax_tree))
  port_model.eval()
  t_tf_export.export_tf_saved_model(port_model, (1, 32, 32, 1),
                                    str(tmp_path / 'port'),
                                    input_name='image', with_gradient=True)
  x = np.random.default_rng(8).standard_normal((1, 32, 32, 1)).astype(
      np.float32)
  check_gradients(tmp_path / 'jax', tmp_path / 'port', port_model, x, 1e-4,
                  relative=True)


def test_aligner_with_gradient(tmp_path):
  jax_params, flax_tree = _fixture_params('image_aligner')
  module = j_align_model.GlobalLocalUNet(
      local_output_size=9, global_output_size=6, features=(4, 8))

  def fn(image):
    local, global_out = module.apply({'params': jax_params}, image)
    return local, global_out

  j_tf_export.export_tf_saved_model(jax.jit(fn), (1, 32, 32, 3),
                                    str(tmp_path / 'jax'), input_name='image',
                                    with_gradient=True)
  port_model = t_align_model.from_flax(flax_tree)
  t_tf_export.export_tf_saved_model(port_model, (1, 32, 32, 3),
                                    str(tmp_path / 'port'),
                                    input_name='image', with_gradient=True)
  x = np.random.default_rng(9).standard_normal((1, 32, 32, 3)).astype(
      np.float32)
  check_gradients(tmp_path / 'jax', tmp_path / 'port', port_model, x, 1e-4,
                  relative=True)


# --- the CLIs -------------------------------------------------------------------


def test_save_model_clis_export_saved_models(tmp_path, capsys):
  det_dir, align_dir = tmp_path / 'det', tmp_path / 'align'
  det_dir.mkdir()
  align_dir.mkdir()
  det_state = t_det_train.create_state(
      t_det_train.Config(workdir='', features=(4, 8)), device='cpu')
  t_det_train.save_params_msgpack(det_state.model, str(det_dir))
  align_state = t_align_train.create_state(
      t_align_train.Config(workdir='', features=(4, 8), num_frames=3),
      device='cpu')
  t_align_train.save_params_msgpack(align_state.model, str(align_dir))
  cases = (
      (t_det_save.main, det_dir, det_state.model, (1, 32, 32, 1),
       ['--features', '4', '8']),
      (t_align_save.main, align_dir, align_state.model, (1, 32, 32, 3),
       ['--num_frames=3', '--features', '4', '8']))
  for main, workdir, model, shape, extra in cases:
    out = tmp_path / f'{workdir.name}_art'
    main([f'--workdir={workdir}', f'--output_dir={out}', '--image_size=32',
          '--export_tf', '--device=cpu', *extra])
    assert capsys.readouterr().out.splitlines() == [
        f'Saved native artifact to {out}', 'Exported TF SavedModel.']
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
      native = model.eval()(torch.from_numpy(x))
    native = native if isinstance(native, tuple) else (native,)
    port = t_tf_export.load_tf_saved_model(str(out / 'tf_saved_model'),
                                           device='cpu')(x)
    port = port if isinstance(port, tuple) else (port,)
    tf_out = tf.saved_model.load(str(out / 'tf_saved_model'))(x)
    tf_out = tf_out if isinstance(tf_out, (tuple, list)) else (tf_out,)
    for n, p, t in zip(native, port, tf_out, strict=True):
      np.testing.assert_allclose(p.numpy(), n.numpy(), rtol=1e-4, atol=1e-5)
      np.testing.assert_allclose(np.asarray(t), p.numpy(), rtol=1e-3,
                                 atol=1e-4)
    assert 'image' in tf.saved_model.load(str(
        out / 'tf_saved_model')).signatures[
            'serving_default'].structured_input_signature[1]
  assert os.path.exists(tmp_path / 'det_art' / 'model.json')
