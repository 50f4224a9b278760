"""FLOPs of one forward of the UNet detector on one frame."""

from benchmark.lib import flops as flops_lib


def flops(model: dict) -> int:
  return flops_lib.unet(int(model['image_size']), model['features'],
                        int(model['num_classes']))
