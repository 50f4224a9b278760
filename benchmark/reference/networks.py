"""The two shipped networks in plain PyTorch, from flax parameter trees.

Actor-critic (the pixel PPO policy): 3x3 stride-2 convolutions with
flax's 'SAME' padding and ReLU over the NHWC frame, flattened in NHWC
order, the goal delta appended, a tanh tower and a tanh mean head.

UNet (the atom detector): per level a 3x3 'SAME' convolution, LayerNorm
over channels (eps 1e-6) and tanh-approximated GELU, 2x2 max pooling
down; up, flax's stride-2 ConvTranspose (the input dilated by 2, padded 2
before and 1 after, correlated with the stored kernel), the skip
concatenated after the upsampled map, a block; a 1x1 head.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import precision as precision_lib


def tensors(tree, device, dtype=torch.float32):
  """A flax tree of numpy arrays as torch tensors on `device`."""
  if isinstance(tree, dict):
    return {k: tensors(v, device, dtype) for k, v in tree.items()}
  return torch.as_tensor(np.asarray(tree, np.float32), device=device,
                         dtype=dtype)


def _oihw(kernel):
  return kernel.permute(3, 2, 0, 1).contiguous()


def _same(size: int, k: int, stride: int):
  out = -(-size // stride)
  total = max((out - 1) * stride + k - size, 0)
  return total // 2, total - total // 2


def actor_critic_mean(params: dict, image: torch.Tensor, goal: torch.Tensor,
                      precision: str = 'float32') -> torch.Tensor:
  """The policy's mean action (B, A) for NHWC frames and goal deltas."""
  convs = sorted((k for k in params if k.startswith('conv_')),
                 key=lambda k: int(k.split('_')[1]))
  dense = sorted((k for k in params if k.startswith('Dense_')),
                 key=lambda k: int(k.split('_')[1]))
  r = lambda t: precision_lib.round_to(t, precision)  # noqa: E731
  with precision_lib.matmul_mode(precision):
    x = image.permute(0, 3, 1, 2)
    for name in convs:
      ph, pw = _same(x.shape[-2], 3, 2), _same(x.shape[-1], 3, 2)
      x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
      x = F.relu(F.conv2d(r(x), r(_oihw(params[name]['kernel'])),
                          params[name]['bias'], stride=2))
    x = torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), goal], -1)
    for name in dense:
      x = torch.tanh(r(x) @ r(params[name]['kernel']) + params[name]['bias'])
    head = params['policy_mean']
    return torch.tanh(r(x) @ r(head['kernel']) + head['bias'])


def _gelu(x):
  return 0.5 * x * (1.0 + torch.tanh(
      math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def _block(params, conv, norm, x):
  k = params[conv]['kernel']
  x = F.conv2d(x, _oihw(k).to(x.dtype), params[conv]['bias'].to(x.dtype),
               padding=k.shape[0] // 2)
  mean = x.mean(dim=1, keepdim=True)
  var = torch.square(x - mean).mean(dim=1, keepdim=True)
  x = (x - mean) * torch.rsqrt(var + 1e-6)
  x = (x * params[norm]['scale'].to(x.dtype)[None, :, None, None]
       + params[norm]['bias'].to(x.dtype)[None, :, None, None])
  return _gelu(x)


def _up(params, name, x):
  b, c, h, w = x.shape
  dilated = x.new_zeros((b, c, 2 * h - 1, 2 * w - 1))
  dilated[:, :, ::2, ::2] = x
  dilated = F.pad(dilated, (2, 1, 2, 1))
  k = params[name]['kernel'].to(x.dtype)
  return F.conv2d(dilated, _oihw(k), params[name]['bias'].to(x.dtype))


def unet_logits(params: dict, image: torch.Tensor,
                precision: str = 'float32') -> torch.Tensor:
  """Class logits (B, H, W, 3) of NHWC frames (B, H, W, 1)."""
  levels = sum(1 for k in params if k.startswith('down_'))
  dtype = torch.bfloat16 if precision == 'bfloat16' else torch.float32
  with precision_lib.matmul_mode(precision):
    x = image.permute(0, 3, 1, 2).to(dtype)
    skips = []
    for d in range(levels):
      x = _block(params, f'down_{d}', f'LayerNorm_{d}', x)
      skips.append(x)
      x = F.max_pool2d(x, 2)
    x = _block(params, 'bottleneck', f'LayerNorm_{levels}', x)
    for i, d in enumerate(reversed(range(levels))):
      x = torch.cat([_up(params, f'up_transpose_{d}', x), skips.pop()], 1)
      x = _block(params, f'up_{d}', f'LayerNorm_{levels + 1 + i}', x)
    k = params['head']['kernel']
    x = F.conv2d(x, _oihw(k).to(dtype), params['head']['bias'].to(dtype))
  return x.permute(0, 2, 3, 1).to(torch.float32)
