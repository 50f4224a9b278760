"""Packages the best image-alignment checkpoint for deployment.

Port of putting_dune_tpu/image_alignment/save_model.py: reads the trained
params (`train.load_params`: params.msgpack, else the best checkpoint by
drift error) and writes `params.msgpack` (flax bytes) and `model.json`
with the JAX package's keys into --output_dir.

  python -m putting_dune_torch.image_alignment.save_model \
      --workdir=runs/align --output_dir=runs/align_artifact

--export_tf (a TF SavedModel) waits for the IO slice and exits 2.
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
  args = parser.parse_args(argv)
  if args.export_tf:
    parser.error('--export_tf: TF SavedModel export is not ported yet '
                 '(ROADMAP queue 1, IO).')

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


if __name__ == '__main__':
  main()
