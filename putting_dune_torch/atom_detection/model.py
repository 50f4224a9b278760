"""UNet for STEM-image semantic segmentation.

Port of putting_dune_tpu/atom_detection/model.py: encoder-decoder with
skip connections, each block a 3x3 convolution + LayerNorm over channels
(eps 1e-6, scale and bias) + tanh-approximated GELU, 2x2 max pooling on
the way down, a stride-2 3x3 transposed convolution on the way up, and a
1x1 head over the classes (background, carbon, silicon).

Like the JAX module it takes and returns NHWC: (B, H, W, C) -> logits
(B, H, W, num_classes), H and W divisible by 2**(len(features)-1). Inside
it works on NCHW tensors in the channels_last memory format, which is the
same memory layout as NHWC. The convolutions are PyTorch's (cuDNN on the
card), as the JAX package leaves them to XLA.

`params_from_flax` turns the flax parameter tree into this module's
state_dict. The transposed convolution follows flax's `nn.ConvTranspose(
strides=(2, 2), padding='SAME')`: the stride-dilated input padded 2 before
and 1 after, correlated with the kernel as stored (not flipped). That is
`conv_transpose2d(stride=2, padding=0)` with the spatially flipped kernel,
less its last output row and column.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


class _ChannelLayerNorm(nn.Module):
  """LayerNorm over the channel axis of an NCHW tensor (a view as NHWC,
  which in channels_last memory is the tensor as it lies)."""

  def __init__(self, channels: int, eps: float = 1e-6):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))
    self.eps = eps

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(
        x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, self.eps
    )
    return y.permute(0, 3, 1, 2)


class _Block(nn.Module):
  """3x3 'SAME' convolution + channel LayerNorm + tanh GELU."""

  def __init__(self, in_channels: int, width: int):
    super().__init__()
    self.conv = nn.Conv2d(in_channels, width, 3, padding=1)
    self.norm = _ChannelLayerNorm(width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(self.norm(self.conv(x)), approximate='tanh')


class _UpTranspose(nn.Module):
  """flax `ConvTranspose(width, (3, 3), strides=(2, 2), padding='SAME')`."""

  def __init__(self, in_channels: int, width: int):
    super().__init__()
    self.conv = nn.ConvTranspose2d(in_channels, width, 3, stride=2)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    return self.conv(x)[..., :2 * h, :2 * w]


class UNet(nn.Module):
  """Encoder-decoder segmentation network over NHWC inputs."""

  def __init__(
      self,
      num_classes: int = 3,
      features: Sequence[int] = (64, 128, 256, 512, 1024),
      in_channels: int = 1,
  ):
    super().__init__()
    self.features = tuple(features)
    self.num_classes = num_classes
    levels = len(self.features) - 1
    down, channels = [], in_channels
    for width in self.features[:-1]:
      down.append(_Block(channels, width))
      channels = width
    self.down = nn.ModuleList(down)
    self.bottleneck = _Block(channels, self.features[-1])
    # Indexed by depth, like the JAX module's up_transpose_{depth}.
    self.up_transpose = nn.ModuleList(
        _UpTranspose(self.features[d + 1], self.features[d])
        for d in range(levels)
    )
    self.up = nn.ModuleList(
        _Block(2 * self.features[d], self.features[d]) for d in range(levels)
    )
    self.head = nn.Conv2d(self.features[0], num_classes, 1)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    single = x.dim() == 3
    if single:
      x = x[None]
    multiple = 2 ** (len(self.features) - 1)
    if x.shape[1] % multiple or x.shape[2] % multiple:
      raise ValueError(
          f'UNet: H and W must be divisible by {multiple}, got '
          f'{tuple(x.shape)}.')
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    skips = []
    for block in self.down:
      x = block(x)
      skips.append(x)
      x = F.max_pool2d(x, 2)
    x = self.bottleneck(x)
    for depth in reversed(range(len(self.down))):
      x = self.up_transpose[depth](x)
      x = torch.cat([x, skips.pop()], dim=1)
      x = self.up[depth](x)
    x = self.head(x).permute(0, 2, 3, 1)
    return x[0] if single else x


def _conv_weight(kernel: np.ndarray) -> torch.Tensor:
  """flax HWIO -> torch OIHW."""
  return torch.from_numpy(np.ascontiguousarray(
      np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def _conv_transpose_weight(kernel: np.ndarray) -> torch.Tensor:
  """flax HWIO (I = input features) -> torch IOHW, spatially flipped."""
  flipped = np.asarray(kernel, np.float32)[::-1, ::-1]
  return torch.from_numpy(np.ascontiguousarray(
      np.transpose(flipped, (2, 3, 0, 1))))


def features_from_flax(params: Mapping) -> tuple[int, ...]:
  """The feature pyramid a flax UNet parameter tree was built with."""
  levels = sum(1 for name in params if name.startswith('down_'))
  widths = [params[f'down_{d}']['bias'].shape[0] for d in range(levels)]
  return (*widths, params['bottleneck']['bias'].shape[0])


def params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
  """The flax UNet parameter tree as a `UNet` state_dict.

  The unnamed flax LayerNorms are numbered in call order: LayerNorm_d for
  down_d, then the bottleneck, then the up blocks from the deepest.
  """
  levels = sum(1 for name in params if name.startswith('down_'))
  vec = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())  # noqa: E731
  state = {}

  def block(prefix: str, conv_name: str, norm_index: int) -> None:
    state[f'{prefix}.conv.weight'] = _conv_weight(params[conv_name]['kernel'])
    state[f'{prefix}.conv.bias'] = vec(params[conv_name]['bias'])
    norm = params[f'LayerNorm_{norm_index}']
    state[f'{prefix}.norm.weight'] = vec(norm['scale'])
    state[f'{prefix}.norm.bias'] = vec(norm['bias'])

  for d in range(levels):
    block(f'down.{d}', f'down_{d}', d)
  block('bottleneck', 'bottleneck', levels)
  for i, d in enumerate(reversed(range(levels))):
    block(f'up.{d}', f'up_{d}', levels + 1 + i)
    up = params[f'up_transpose_{d}']
    state[f'up_transpose.{d}.conv.weight'] = _conv_transpose_weight(
        up['kernel'])
    state[f'up_transpose.{d}.conv.bias'] = vec(up['bias'])
  state['head.weight'] = _conv_weight(params['head']['kernel'])
  state['head.bias'] = vec(params['head']['bias'])
  return state
