"""Model FLOPs from layer shapes: 2 x multiply-adds of every convolution
and dense layer (elementwise work, norms and activations not counted)."""

from __future__ import annotations


def conv(c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> int:
  return 2 * c_in * c_out * k * k * h_out * w_out


def dense(n_in: int, n_out: int) -> int:
  return 2 * n_in * n_out


def actor_critic(image_size: int, conv_features=(16, 32, 64),
                 hidden=(256, 256), action_dim: int = 2, goal_dim: int = 2
                 ) -> int:
  """One forward of the pixel actor-critic on one frame: 3x3 stride-2
  'SAME' convolutions, the tower, the mean and value heads."""
  total, size, c_in = 0, image_size, 1
  for c_out in conv_features:
    size = -(-size // 2)
    total += conv(c_in, c_out, 3, size, size)
    c_in = c_out
  n_in = c_in * size * size + goal_dim
  for width in hidden:
    total += dense(n_in, width)
    n_in = width
  return total + dense(n_in, action_dim) + dense(n_in, 1)


def unet(image_size: int, features=(64, 128, 256, 512, 1024),
         num_classes: int = 3) -> int:
  """One forward of the UNet on one frame: a 3x3 block a level down, the
  bottleneck, a 3x3 stride-2 transposed convolution and a 3x3 block a
  level up (on the concatenated skip), the 1x1 head."""
  total, size, c_in = 0, image_size, 1
  for width in features[:-1]:
    total += conv(c_in, width, 3, size, size)
    c_in, size = width, size // 2
  total += conv(c_in, features[-1], 3, size, size)
  for d in reversed(range(len(features) - 1)):
    total += conv(features[d + 1], features[d], 3, size, size)  # per input
    size *= 2
    total += conv(2 * features[d], features[d], 3, size, size)
  return total + conv(features[0], num_classes, 1, size, size)
