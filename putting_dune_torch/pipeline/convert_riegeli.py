"""Converts record files between riegeli and TFRecord, record for record.

Port of putting_dune_tpu/pipeline/convert_riegeli.py. `read_records` and
`write_records` take `.riegeli` paths directly; this CLI rewraps a file's
payloads byte for byte in the other container:

  python -m putting_dune_torch.pipeline.convert_riegeli \\
      --source_path=trajectories.riegeli --target_path=trajectories.tfrecords
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

from putting_dune_torch.io import records


@dataclasses.dataclass
class Args:
  source_path: str
  target_path: str


def convert(source_path: str, target_path: str) -> int:
  """Rewraps records byte for byte; returns the record count."""
  payloads = records.read_records(source_path)
  records.write_records(target_path, payloads)
  return len(payloads)


def main(args: Args) -> None:
  src_ext = os.path.splitext(args.source_path)[1]
  dst_ext = os.path.splitext(args.target_path)[1]
  if '.riegeli' not in (src_ext, dst_ext):
    raise ValueError('One of source/target must be .riegeli '
                     f'(got {src_ext} -> {dst_ext}).')
  n = convert(args.source_path, args.target_path)
  print(f'Converted {n} records: {args.source_path} -> {args.target_path}')


def _parse_args(argv: Optional[Sequence[str]] = None) -> Args:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--source_path', required=True)
  parser.add_argument('--target_path', required=True)
  return Args(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
  main(_parse_args())
