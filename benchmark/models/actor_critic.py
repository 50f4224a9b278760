"""FLOPs of one forward of the pixel actor-critic on one frame."""

from benchmark.lib import flops as flops_lib


def flops(model: dict) -> int:
  return flops_lib.actor_critic(
      int(model['image_size']), model['conv_features'], model['hidden'],
      int(model['action_dim']))
