"""The PPO actor-critic forward pass (port of putting_dune_tpu/agents/ppo.py
`ActorCritic`), and its construction from flax parameters.

Image observations {'image': (B, H, W, 1), 'goal_delta_angstroms': (B, 2)}
go through three 3x3 stride-2 convolutions with flax's 'SAME' padding and
ReLU, are flattened in NHWC order and concatenated with the goal delta,
then a tanh MLP tower feeds a tanh mean head, a state-independent log_std
and a value head. The vector-observation tower and training are not
ported yet.

On CUDA the convolutions run with cuDNN's TF32 disabled (its default is
on), so the policy computes in full float32 like the JAX package on CPU.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
  """flax/XLA 'SAME': out = ceil(size / stride), extra pad at the end."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


class ActorCritic(nn.Module):
  """Gaussian policy + value head over image-dict observations."""

  def __init__(
      self,
      action_dim: int = 2,
      hidden: Sequence[int] = (256, 256),
      conv_features: Sequence[int] = (16, 32, 64),
      image_size: int = 128,
  ):
    super().__init__()
    self.convs = nn.ModuleList()
    channels, size = 1, image_size
    for f in conv_features:
      self.convs.append(nn.Conv2d(channels, f, 3, stride=2, padding=0))
      channels, size = f, -(-size // 2)
    in_features = channels * size * size + 2
    self.hidden = nn.ModuleList()
    for width in hidden:
      self.hidden.append(nn.Linear(in_features, width))
      in_features = width
    self.policy_mean = nn.Linear(in_features, action_dim)
    self.value = nn.Linear(in_features, 1)
    self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))

  def _encode(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    x = obs['image'].permute(0, 3, 1, 2)  # NHWC -> NCHW
    for conv in self.convs:
      ph = _same_padding(x.shape[-2], 3, 2)
      pw = _same_padding(x.shape[-1], 3, 2)
      x = F.relu(conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
    return torch.cat([x, obs['goal_delta_angstroms']], dim=-1)

  def forward(self, obs):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
      x = self._encode(obs)
    for layer in self.hidden:
      x = torch.tanh(layer(x))
    mean = torch.tanh(self.policy_mean(x))
    value = self.value(x)[..., 0]
    return mean, self.log_std.expand_as(mean), value


def actor_critic_from_flax(
    params: Mapping[str, Mapping[str, np.ndarray]],
    *,
    image_size: int = 128,
) -> ActorCritic:
  """Builds an ActorCritic holding flax ActorCritic parameters.

  Conv kernels go HWIO -> OIHW, Dense kernels (in, out) -> (out, in).
  """
  conv_names = sorted(
      (k for k in params if k.startswith('conv_')),
      key=lambda k: int(k.split('_')[1]),
  )
  dense_names = sorted(
      (k for k in params if k.startswith('Dense_')),
      key=lambda k: int(k.split('_')[1]),
  )
  conv_features = [params[k]['kernel'].shape[-1] for k in conv_names]
  hidden = [params[k]['kernel'].shape[-1] for k in dense_names]
  action_dim = params['policy_mean']['kernel'].shape[-1]
  model = ActorCritic(action_dim, hidden, conv_features, image_size)

  def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

  with torch.no_grad():
    for conv, name in zip(model.convs, conv_names):
      conv.weight.copy_(t(params[name]['kernel'].transpose(3, 2, 0, 1)))
      conv.bias.copy_(t(params[name]['bias']))
    for layer, name in zip(model.hidden, dense_names):
      if layer.weight.shape != params[name]['kernel'].T.shape:
        raise ValueError(f'{name}: shape {params[name]["kernel"].shape} '
                         f'does not fit {tuple(layer.weight.shape)}')
      layer.weight.copy_(t(params[name]['kernel'].T))
      layer.bias.copy_(t(params[name]['bias']))
    for name in ('policy_mean', 'value'):
      layer = getattr(model, name)
      layer.weight.copy_(t(params[name]['kernel'].T))
      layer.bias.copy_(t(params[name]['bias']))
    model.log_std.copy_(t(params['log_std']))
  return model.eval()
