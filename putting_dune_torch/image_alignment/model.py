"""Global-local UNet: per-pixel segmentation + global drift regression.

Port of putting_dune_tpu/image_alignment/model.py. A UNet trunk over a
T-frame stack (a 7x7 stem, then the atom detector's blocks: 'SAME'
convolution + channel LayerNorm + tanh GELU, 2x2 max pooling, flax's
'SAME' stride-2 transposed convolution on the way up) with two heads:

  * local: a 7x7 convolution to `local_output_size` channels per pixel (3
    classes for each of the T frames, frame-major: channel 3 t + c);
  * global, from the bottleneck: a 1x1 convolution to 256 channels,
    LayerNorm, tanh GELU, the spatial mean and a Dense to
    `global_output_size` (the (T, 2) drift, frame-major).

Like the JAX module it takes NHWC, (B, H, W, T), and returns (local
(B, H, W, local_output_size) NHWC, global (B, global_output_size)); H and
W must be divisible by 2**(len(features) - 1). `params_from_flax` maps
the flax parameter tree onto the module's state_dict, and `params_to_flax`
maps a state_dict (or the module) back onto the flax tree.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from putting_dune_torch.atom_detection import model as unet_lib

GLOBAL_WIDTH = 256


class GlobalLocalUNet(nn.Module):
  """UNet emitting (segmentation logits, global drift vector)."""

  def __init__(
      self,
      local_output_size: int = 3,
      global_output_size: int = 2,
      features: Sequence[int] = (64, 128, 256, 512, 1024),
      in_channels: int = 1,
  ):
    super().__init__()
    self.features = tuple(features)
    levels = len(self.features) - 1
    self.stem = unet_lib._Block(in_channels, self.features[0], kernel=7)
    down, channels = [], self.features[0]
    for width in self.features[:-1]:
      down.append(unet_lib._Block(channels, width))
      channels = width
    self.down = nn.ModuleList(down)
    self.bottleneck = unet_lib._Block(channels, self.features[-1])
    self.up_transpose = nn.ModuleList(
        unet_lib._UpTranspose(self.features[d + 1], self.features[d])
        for d in range(levels))
    self.up = nn.ModuleList(
        unet_lib._Block(2 * self.features[d], self.features[d])
        for d in range(levels))
    self.local_head = nn.Conv2d(self.features[0], local_output_size, 7,
                                padding=3)
    self.global_conv = nn.Conv2d(self.features[-1], GLOBAL_WIDTH, 1)
    self.global_norm = unet_lib._ChannelLayerNorm(GLOBAL_WIDTH)
    self.global_head = nn.Linear(GLOBAL_WIDTH, global_output_size)

  def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    single = x.dim() == 3
    if single:
      x = x[None]
    multiple = 2 ** (len(self.features) - 1)
    if x.shape[1] % multiple or x.shape[2] % multiple:
      raise ValueError(
          f'GlobalLocalUNet: H and W must be divisible by {multiple}, got '
          f'{tuple(x.shape)}.')
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = self.stem(x)
    skips = []
    for block in self.down:
      x = block(x)
      skips.append(x)
      x = F.max_pool2d(x, 2)
    x = self.bottleneck(x)
    bottleneck = x
    for depth in reversed(range(len(self.down))):
      x = self.up_transpose[depth](x)
      x = torch.cat([x, skips.pop()], dim=1)
      x = self.up[depth](x)
    local = self.local_head(x).permute(0, 2, 3, 1)
    g = F.gelu(self.global_norm(self.global_conv(bottleneck)),
               approximate='tanh')
    global_out = self.global_head(g.mean(dim=(-2, -1)))
    if single:
      return local[0], global_out[0]
    return local, global_out


def params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
  """The flax GlobalLocalUNet parameter tree as a state_dict.

  The unnamed flax LayerNorms are numbered in call order: the stem's, the
  down blocks', the bottleneck's, the up blocks' from the deepest, then
  the global head's.
  """
  levels = sum(1 for name in params if name.startswith('down_'))
  vec = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())  # noqa: E731
  state = {}

  def conv(prefix: str, name: str) -> None:
    state[f'{prefix}.weight'] = unet_lib._conv_weight(params[name]['kernel'])
    state[f'{prefix}.bias'] = vec(params[name]['bias'])

  def norm(prefix: str, index: int) -> None:
    state[f'{prefix}.weight'] = vec(params[f'LayerNorm_{index}']['scale'])
    state[f'{prefix}.bias'] = vec(params[f'LayerNorm_{index}']['bias'])

  conv('stem.conv', 'stem')
  norm('stem.norm', 0)
  for d in range(levels):
    conv(f'down.{d}.conv', f'down_{d}')
    norm(f'down.{d}.norm', 1 + d)
  conv('bottleneck.conv', 'bottleneck')
  norm('bottleneck.norm', 1 + levels)
  for i, d in enumerate(reversed(range(levels))):
    conv(f'up.{d}.conv', f'up_{d}')
    norm(f'up.{d}.norm', 2 + levels + i)
    up = params[f'up_transpose_{d}']
    state[f'up_transpose.{d}.conv.weight'] = (
        unet_lib._conv_transpose_weight(up['kernel']))
    state[f'up_transpose.{d}.conv.bias'] = vec(up['bias'])
  conv('local_head', 'local_head')
  conv('global_conv', 'global_conv')
  norm('global_norm', 2 + 2 * levels)
  state['global_head.weight'] = vec(
      np.asarray(params['global_head']['kernel']).T)
  state['global_head.bias'] = vec(params['global_head']['bias'])
  return state


def from_flax(params: Mapping) -> GlobalLocalUNet:
  """A GlobalLocalUNet holding a flax parameter tree; the widths, frame
  count and output sizes are read from the kernels."""
  model = GlobalLocalUNet(
      local_output_size=params['local_head']['bias'].shape[0],
      global_output_size=params['global_head']['bias'].shape[0],
      features=unet_lib.features_from_flax(params),
      in_channels=params['stem']['kernel'].shape[2],
  )
  model.load_state_dict(params_from_flax(params))
  return model.eval()


def params_to_flax(model_or_state) -> dict:
  """A `GlobalLocalUNet` (or its state_dict) as the flax parameter tree,
  float32 numpy leaves in the order flax creates them."""
  state = unet_lib.state_dict_of(model_or_state)
  levels = sum(1 for k in state if k.startswith('down.')
               and k.endswith('.conv.weight'))
  vec = unet_lib._np
  params = {}

  def conv(name: str, prefix: str) -> None:
    params[name] = {'kernel': unet_lib.conv_kernel(state[f'{prefix}.weight']),
                    'bias': vec(state[f'{prefix}.bias'])}

  def norm(index: int, prefix: str) -> None:
    params[f'LayerNorm_{index}'] = {'scale': vec(state[f'{prefix}.weight']),
                                    'bias': vec(state[f'{prefix}.bias'])}

  conv('stem', 'stem.conv')
  norm(0, 'stem.norm')
  for d in range(levels):
    conv(f'down_{d}', f'down.{d}.conv')
    norm(1 + d, f'down.{d}.norm')
  conv('bottleneck', 'bottleneck.conv')
  norm(1 + levels, 'bottleneck.norm')
  for i, d in enumerate(reversed(range(levels))):
    params[f'up_transpose_{d}'] = {
        'kernel': unet_lib.conv_transpose_kernel(
            state[f'up_transpose.{d}.conv.weight']),
        'bias': vec(state[f'up_transpose.{d}.conv.bias'])}
    conv(f'up_{d}', f'up.{d}.conv')
    norm(2 + levels + i, f'up.{d}.norm')
  conv('local_head', 'local_head')
  conv('global_conv', 'global_conv')
  norm(2 + 2 * levels, 'global_norm')
  params['global_head'] = {
      'kernel': np.ascontiguousarray(vec(state['global_head.weight']).T),
      'bias': vec(state['global_head.bias'])}
  return params
