"""What the SavedModel interop tests hold a port export and a JAX export
of the same weights to (tests/test_torch_tf_interop_{models,unets}.py),
outputs and, for exports with gradients, gradients."""

import ctypes
import os

import numpy as np
import tensorflow as tf
import torch

from putting_dune_torch.io import tf_export as t_tf_export


def flat(out):
  if isinstance(out, dict):
    return [out[k] for k in sorted(out)]
  return list(out) if isinstance(out, (tuple, list)) else [out]


def check(jax_dir, port_dir, x, native, rtol, atol):
  """Port loader on the JAX export vs JAX; TF on the port's export vs TF
  on the JAX export; equal signatures and output structure."""
  port = t_tf_export.load_tf_saved_model(str(jax_dir), device='cpu')
  got = port(x)
  assert isinstance(got, tuple) == isinstance(native, tuple)
  for g, n in zip(flat(got), flat(native), strict=True):
    np.testing.assert_allclose(g.numpy(), np.asarray(n), rtol=rtol,
                               atol=atol)
  tf_jax, tf_port = (tf.saved_model.load(str(d)) for d in (jax_dir, port_dir))
  want, have = tf_jax(x), tf_port(x)
  assert type(want) == type(have)  # pylint: disable=unidiomatic-typecheck
  for h, w in zip(flat(have), flat(want), strict=True):
    np.testing.assert_allclose(np.asarray(h), np.asarray(w), rtol=rtol,
                               atol=atol)
  sig_jax = tf_jax.signatures['serving_default']
  sig_port = tf_port.signatures['serving_default']
  assert (list(sig_jax.structured_input_signature[1])
          == list(sig_port.structured_input_signature[1]))
  assert sorted(sig_jax.structured_outputs) == sorted(
      sig_port.structured_outputs)
  name = list(sig_jax.structured_input_signature[1])[0]
  for key, value in sig_port(**{name: tf.constant(x)}).items():
    np.testing.assert_allclose(np.asarray(value), np.asarray(
        sig_jax(**{name: tf.constant(x)})[key]), rtol=rtol, atol=atol)


def run_with_c_api(save_dir, input_op: str, x: np.ndarray,
                   out_shape) -> np.ndarray:
  """Loads the SavedModel with TF's C API (`TF_LoadSessionFromSavedModel`,
  the C++ loader that TF Serving uses) and runs `serving_default`'s first
  output on one float32 input."""
  lib = ctypes.CDLL(os.path.join(os.path.dirname(tf.__file__),
                                 'libtensorflow_cc.so.2'))
  vp = ctypes.c_void_p
  for name, restype in (('TF_NewSessionOptions', vp), ('TF_NewGraph', vp),
                        ('TF_NewStatus', vp), ('TF_GetCode', ctypes.c_int),
                        ('TF_Message', ctypes.c_char_p),
                        ('TF_LoadSessionFromSavedModel', vp),
                        ('TF_GraphOperationByName', vp), ('TF_NewTensor', vp),
                        ('TF_TensorData', vp), ('TF_SessionRun', None)):
    getattr(lib, name).restype = restype

  class Output(ctypes.Structure):
    _fields_ = [('oper', vp), ('index', ctypes.c_int)]

  graph, status = vp(lib.TF_NewGraph()), vp(lib.TF_NewStatus())
  session = lib.TF_LoadSessionFromSavedModel(
      vp(lib.TF_NewSessionOptions()), None, str(save_dir).encode(),
      (ctypes.c_char_p * 1)(b'serve'), 1, graph, None, status)
  assert lib.TF_GetCode(status) == 0, lib.TF_Message(status)
  x = np.ascontiguousarray(x, np.float32)
  keep = ctypes.CFUNCTYPE(None, vp, ctypes.c_size_t, vp)(lambda *_: None)
  tensor = lib.TF_NewTensor(1, (ctypes.c_int64 * x.ndim)(*x.shape), x.ndim,
                            x.ctypes.data_as(vp), x.nbytes, keep, None)
  inp = Output(lib.TF_GraphOperationByName(graph, input_op.encode()), 0)
  out = Output(lib.TF_GraphOperationByName(graph,
                                           b'StatefulPartitionedCall'), 0)
  result = (vp * 1)()
  lib.TF_SessionRun(vp(session), None, ctypes.byref(inp), (vp * 1)(tensor),
                    1, ctypes.byref(out), result, 1, None, 0, None, status)
  assert lib.TF_GetCode(status) == 0, lib.TF_Message(status)
  data = ctypes.cast(lib.TF_TensorData(vp(result[0])),
                     ctypes.POINTER(ctypes.c_float))
  return np.ctypeslib.as_array(data, tuple(out_shape)).copy()


def tf_gradient(save_dir, x, cotangents) -> np.ndarray:
  """TF's `GradientTape` gradient of sum(output * cotangent) in x through
  the loaded SavedModel."""
  loaded = tf.saved_model.load(str(save_dir))
  xt = tf.constant(x)
  with tf.GradientTape() as tape:
    tape.watch(xt)
    outs = flat(loaded(xt))
    loss = tf.add_n([tf.reduce_sum(o * c) for o, c in zip(outs, cotangents)])
  return tape.gradient(loss, xt).numpy()


def port_gradient(save_dir, x, cotangents) -> np.ndarray:
  """The same through the port's loader, under autograd."""
  loaded = t_tf_export.load_tf_saved_model(str(save_dir), device='cpu')
  xt = torch.tensor(x, requires_grad=True)
  outs = flat(loaded(xt))
  sum((o * torch.as_tensor(np.asarray(c))).sum() for o, c in zip(outs, cotangents)
      ).backward()
  return xt.grad.numpy()


def check_gradients(jax_dir, port_dir, module, x, tol, relative=False):
  """With-gradient exports: TF on the port's export, and the port's loader
  on it, equal torch autograd on `module`; the port's loader on the JAX
  package's export, and TF on the port's export, equal TF on the JAX
  package's export (JAX's gradient of the same weights). Within `tol`,
  times the largest gradient where `relative`."""
  xt = torch.tensor(x, requires_grad=True)
  outs = flat(module(xt))
  rng = np.random.default_rng(11)
  cotangents = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
                for o in outs]
  sum((o * torch.as_tensor(np.asarray(c))).sum() for o, c in zip(outs, cotangents)
      ).backward()
  native = xt.grad.numpy()
  atol = tol * float(np.abs(native).max()) if relative else tol
  for got in (tf_gradient(port_dir, x, cotangents),
              port_gradient(port_dir, x, cotangents)):
    np.testing.assert_allclose(got, native, rtol=0, atol=atol)
  want = tf_gradient(jax_dir, x, cotangents)
  atol = tol * float(np.abs(want).max()) if relative else tol
  for got in (port_gradient(jax_dir, x, cotangents),
              tf_gradient(port_dir, x, cotangents)):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
