"""Port parity for the shipped pixel policy: checkpoint reader and forward.

The port's pure-Python msgpack reader must return the exact arrays that
flax.serialization reads from the shipped `ppo_simple_images_tf`
checkpoint, and the port's ActorCritic mean must equal the JAX
EvalAgent's on the same random batch.
"""

import os

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.agents import msgpack_reader
from putting_dune_torch.agents import ppo as t_ppo
from putting_dune_tpu.agents import eval_agent as j_eval_agent

torch.set_num_threads(2)

CKPT_DIR = os.path.join(t_eval_agent.MODEL_WEIGHTS_DIR, 'ppo_simple_images_tf')


def _flatten(tree, prefix=()):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _flatten(v, prefix + (k,))
  else:
    yield prefix, tree


def test_msgpack_reader_matches_flax_bitwise():
  ours = t_eval_agent.read_flax_params(os.path.join(CKPT_DIR, 'policy.ckpt'))
  with open(os.path.join(CKPT_DIR, 'policy.ckpt'), 'rb') as f:
    theirs = flax.serialization.msgpack_restore(f.read())
  ours_flat = dict(_flatten(ours))
  theirs_flat = dict(_flatten(theirs))
  assert set(ours_flat) == set(theirs_flat)
  assert ours_flat[('Dense_0', 'kernel')].shape == (16386, 256)
  for key, want in theirs_flat.items():
    got = ours_flat[key]
    assert got.dtype == np.asarray(want).dtype, key
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(key))


@pytest.mark.parametrize('value', [
    None, True, False, 0, 127, -32, 200, 70000, -70000, 2**40, -(2**40),
    1.5, 'x' * 40, b'\x00\x01', [1, [2, 3]], {'a': {'b': 1}},
    'y' * 300, list(range(20)), {str(i): i for i in range(20)},
])
def test_msgpack_reader_scalars_and_containers(value):
  assert msgpack_reader.unpackb(msgpack.packb(value, use_bin_type=True)) == value


def test_msgpack_reader_ndarray_and_scalar_ext():
  tree = {'a': np.arange(12, dtype=np.float32).reshape(3, 4),
          'b': np.int64(7), 'c': np.zeros((2,), np.int32)}
  out = msgpack_reader.unpackb(flax.serialization.msgpack_serialize(tree))
  np.testing.assert_array_equal(out['a'], tree['a'])
  assert out['b'] == 7 and out['b'].dtype == np.int64
  np.testing.assert_array_equal(out['c'], tree['c'])


def test_actor_critic_mean_matches_flax():
  jax_agent = j_eval_agent.EvalAgent.load(CKPT_DIR)
  model = t_eval_agent.load_policy(CKPT_DIR, 'cpu')
  rng = np.random.default_rng(0)
  obs = {
      'image': rng.uniform(0, 1, (4, 128, 128, 1)).astype(np.float32),
      'goal_delta_angstroms': rng.normal(size=(4, 2)).astype(np.float32) * 5,
  }
  want = np.asarray(jax_agent.policy()(None, jax.tree_util.tree_map(
      jax.numpy.asarray, obs)))
  got = t_eval_agent.mean_policy(model)(
      None, {k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
  assert got.shape == (4, 2)
  assert np.abs(got - want).max() <= 1e-5


def test_actor_critic_heads_and_same_padding():
  params = t_eval_agent.read_flax_params(os.path.join(CKPT_DIR, 'policy.ckpt'))
  model = t_ppo.actor_critic_from_flax(params)
  obs = {'image': torch.rand(2, 128, 128, 1),
         'goal_delta_angstroms': torch.zeros(2, 2)}
  mean, log_std, value = model(obs)
  assert mean.shape == log_std.shape == (2, 2) and value.shape == (2,)
  np.testing.assert_array_equal(log_std[0].detach().numpy(), params['log_std'])
  # 'SAME' at stride 2 on an even size pads one pixel at the end only.
  assert t_ppo._same_padding(128, 3, 2) == (0, 1)
  assert t_ppo._same_padding(7, 3, 2) == (1, 1)


def test_load_policy_rejects_unported_kinds(tmp_path):
  # 'actor_critic', 'mlp' and 'conv' are every kind the JAX package saves;
  # any other is refused, as EvalAgent.load refuses it.
  (tmp_path / 'policy.json').write_text('{"kind": "transformer", "arch": {}}')
  with pytest.raises(ValueError, match='transformer'):
    t_eval_agent.load_policy(str(tmp_path))


def test_load_policy_defaults_to_cuda():
  # Without a device the loader resolves CUDA (device.resolve_device), so
  # on a machine without a card it raises; the CPU is there when asked.
  if torch.cuda.is_available():
    assert next(t_eval_agent.load_policy(CKPT_DIR).parameters()).is_cuda
  else:
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      t_eval_agent.load_policy(CKPT_DIR)
  model = t_eval_agent.load_policy(CKPT_DIR, device='cpu')
  assert next(model.parameters()).device.type == 'cpu'
