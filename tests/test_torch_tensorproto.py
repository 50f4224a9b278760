"""The port's TensorProto / NDArray image codec against the JAX package's.

Every dtype the codec knows is encoded by both packages in both image wire
formats, bytes equal; each decodes the other's payloads exactly, including
TensorProtos in typed-value form (with TensorFlow's last-value broadcast)
that protobuf builds; the observation and transition round trips of
`microscope_data` write the JAX package's bytes. Exact equality: these are
bytes and integers.
"""

import datetime as dt

import numpy as np
import pytest

from putting_dune_torch import microscope_data as t_md
from putting_dune_torch.io import tensorproto as t_tp
from putting_dune_tpu import microscope_data as j_md
from putting_dune_tpu.io import tensorproto as j_tp
from putting_dune_tpu.proto import putting_dune_tpu_pb2 as pb

DTYPES = [np.float32, np.float64, np.int32, np.uint8, np.int16, np.int8,
          np.int64, np.bool_, np.uint16, np.float16, np.uint32, np.uint64]
FORMATS = [t_tp.NDARRAY_FORMAT, t_tp.TENSORPROTO_FORMAT]


def _arr(dtype, shape=(3, 4), seed=0):
  rng = np.random.default_rng(seed)
  if np.issubdtype(dtype, np.floating):
    return rng.standard_normal(shape).astype(dtype)
  if dtype is np.bool_:
    return rng.uniform(size=shape) > 0.5
  info = np.iinfo(dtype)
  return rng.integers(info.min, min(info.max, 1 << 30), size=shape,
                      endpoint=True).astype(dtype)


@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: np.dtype(d).name)
def test_image_bytes_equal_and_cross_decode(dtype, fmt):
  for shape in ((3, 4), (), (0, 5), (2, 3, 4)):
    a = _arr(dtype, shape=shape, seed=len(shape))
    raw = t_tp.encode_image_bytes(a, fmt)
    assert raw == j_tp.encode_image_bytes(a, fmt)
    # Both packages write a 0-d array as shape (1,) (np.ascontiguousarray).
    want = np.ascontiguousarray(a)
    for decoded in (t_tp.decode_image_bytes(raw), j_tp.decode_image_bytes(raw)):
      assert decoded.dtype == want.dtype and decoded.shape == want.shape
      np.testing.assert_array_equal(decoded, want)


def _typed_protos():
  """TensorProtos in TensorFlow's typed-value forms, built by protobuf."""
  out = []
  for dtype_enum, field, values, shape in (
      (1, 'float_val', [1.0, 2.5], (2, 3)),
      (2, 'double_val', [3.5], ()),
      (3, 'int_val', [1, -2, 3], (3,)),
      (4, 'int_val', [7], (2, 2)),
      (9, 'int64_val', [-5, 2**40], (2,)),
      (10, 'bool_val', [True, False], (1, 2)),
      (19, 'half_val', [15360, 16384], (2,)),  # 1.0, 2.0 in float16 bits
      (22, 'uint32_val', [2**32 - 1], (1,)),
      (23, 'uint64_val', [2**64 - 1, 1], (2,)),
  ):
    msg = pb.TensorProtoCompat(dtype=dtype_enum)
    getattr(msg, field).extend(values)
    for d in shape:
      msg.tensor_shape.dim.add(size=d)
    out.append(msg)
  return out


@pytest.mark.parametrize('msg', _typed_protos(), ids=lambda m: str(m.dtype))
def test_typed_value_forms_decode_as_the_jax_package_does(msg):
  raw = msg.SerializeToString()
  got = t_tp.decode_image_bytes(raw)
  want = j_tp.decode_image_bytes(raw)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)


def test_bad_payloads_raise_in_both():
  for raw in (b'\x0a\x03abc', pb.TensorProtoCompat(dtype=7).SerializeToString(),
              pb.TensorProtoCompat(dtype=99).SerializeToString()):
    with pytest.raises(ValueError):
      t_tp.decode_image_bytes(raw)
    with pytest.raises(ValueError):
      j_tp.decode_image_bytes(raw)
  with pytest.raises(ValueError, match='No TensorProto dtype'):
    t_tp.ndarray_to_tensor_proto(np.zeros(2, np.complex64))
  with pytest.raises(ValueError, match='Unknown image format'):
    t_tp.encode_image_bytes(np.zeros(2), 'png')


def _observation(md, image, label=None):
  rng = np.random.default_rng(0)
  nums = np.full(4, 6)
  nums[1] = 14
  return md.MicroscopeObservation(
      grid=md.AtomicGrid(rng.uniform(0, 1, (4, 2)), nums),
      fov=md.MicroscopeFieldOfView(np.asarray([-5.0, -3.0]),
                                   np.asarray([5.0, 7.0])),
      controls=(md.BeamControl(np.asarray([0.5, 0.5]),
                               dt.timedelta(seconds=1.5), voltage_kv=60.0),),
      elapsed_time=dt.timedelta(seconds=2.0),
      image=image, label_image=label)


@pytest.mark.parametrize('fmt', FORMATS)
def test_observation_and_transition_bytes_equal_the_jax_package(fmt):
  image = _arr(np.float64, shape=(16, 16), seed=11)
  label = (image > 0).astype(np.uint8)
  with t_md.image_wire_format(fmt), j_md.image_wire_format(fmt):
    got = _observation(t_md, image, label).to_proto_bytes()
    want = _observation(j_md, image, label).to_proto_bytes()
    assert got == want
    t_obs, j_obs = _observation(t_md, image), _observation(j_md, image)
    got_t = t_md.Transition(
        grid_before=t_obs.grid, grid_after=t_obs.grid, fov_before=t_obs.fov,
        fov_after=t_obs.fov, controls=t_obs.controls, image_before=image,
        label_image_after=label).to_proto_bytes()
    want_t = j_md.Transition(
        grid_before=j_obs.grid, grid_after=j_obs.grid, fov_before=j_obs.fov,
        fov_after=j_obs.fov, controls=j_obs.controls, image_before=image,
        label_image_after=label).to_proto_bytes()
    assert got_t == want_t
  back = t_md.MicroscopeObservation.from_proto_bytes(want)
  np.testing.assert_array_equal(back.image, image)
  np.testing.assert_array_equal(back.label_image, label)
  assert back.grid == _observation(t_md, None).grid
  assert back.controls[0].current_na is None
  assert back.controls[0].voltage_kv == 60.0
  t = t_md.Transition.from_proto_bytes(want_t)
  np.testing.assert_array_equal(t.image_before, image)
  assert t.image_after is None and t.label_image_before is None


def test_unknown_wire_format_raises():
  with pytest.raises(ValueError, match='wire format'):
    with t_md.image_wire_format('jpeg'):
      pass
