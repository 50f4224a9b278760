"""Packages the best image-alignment checkpoint for deployment.

Port of putting_dune_tpu/image_alignment/save_model.py: reads the trained
params (`train.load_params`: params.msgpack, else the best checkpoint by
drift error) and writes `params.msgpack` (flax bytes) and `model.json`
with the JAX package's keys into --output_dir.

  python -m putting_dune_torch.image_alignment.save_model \
      --workdir=runs/align --output_dir=runs/align_artifact

--export_tf also writes a TF SavedModel of the network at (1, image_size,
image_size, num_frames) with input `image` into <output_dir>/tf_saved_model
(`io/tf_export.py`; --device picks where it is traced, CUDA by default).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--workdir', required=True)
  parser.add_argument('--output_dir', required=True)
  parser.add_argument('--image_size', type=int, default=128)
  parser.add_argument('--num_frames', type=int, default=5)
  parser.add_argument('--features', type=int, nargs='+',
                      default=[32, 64, 128, 256])
  parser.add_argument('--export_tf', action='store_true')
  parser.add_argument('--device', default=None)
  args = parser.parse_args(argv)

  from putting_dune_torch.image_alignment import train as train_lib
  from putting_dune_torch.io import serialization

  params = train_lib.load_params(args.workdir)
  os.makedirs(args.output_dir, exist_ok=True)
  serialization.write_params(params, args.output_dir)
  with open(os.path.join(args.output_dir, 'model.json'), 'w') as f:
    json.dump({'kind': 'global_local_unet',
               'features': list(args.features),
               'image_size': args.image_size,
               'num_frames': args.num_frames}, f)
  print(f'Saved native artifact to {args.output_dir}')

  if args.export_tf:
    from putting_dune_torch import device as device_lib
    from putting_dune_torch.image_alignment import model as model_lib
    from putting_dune_torch.io import tf_export

    # (local, global), as the JAX CLI's exported function returns them.
    module = model_lib.from_flax(params).to(
        device_lib.resolve_device(args.device))
    tf_export.export_tf_saved_model(
        module, (1, args.image_size, args.image_size, args.num_frames),
        os.path.join(args.output_dir, 'tf_saved_model'), input_name='image')
    print('Exported TF SavedModel.')


if __name__ == '__main__':
  main()
