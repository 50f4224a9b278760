"""Imports ORNL microscope dumps (.ndata1) into Trajectory records.

Port of putting_dune_tpu/pipeline/import_microscope_data.py: parses the
ORNL on-disk format (ADF/Label ndata1 stacks + JSON metadata),
reconstructs per-frame FOVs from pixel shifts, attaches beam controls and
dwell times, and writes one Trajectory record file per dataset, as
`.tfrecords` or `.riegeli` (--output_format), images as NDArray or
tensorflow.TensorProto (--image_format):

  python -m putting_dune_torch.pipeline.import_microscope_data \
      --directory=/data/ornl --output_dir=/data/records
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import pathlib
import sys
from typing import Any, Dict, Tuple

import numpy as np

from putting_dune_torch import microscope_data as md
from putting_dune_torch.io import records


def load_dataset(
    dataset_path: pathlib.Path,
) -> Tuple[np.ndarray, Dict[str, Any], Dict[str, Any]]:
  """Loads one ORNL dataset directory.

  Returns (raw_image_stack (N,H,W,C), coordinates by frame, parameters by
  frame).
  """
  adf = np.load(dataset_path / 'ADF-stack-000.ndata1')
  label = np.load(dataset_path / 'Label-stack-000.ndata1')
  raw_image_stack = adf['data']
  label_stack = label['data']
  metadata = json.loads(label['metadata.json'])
  stacklength = len(metadata['metadata'])
  raw_image_stack = raw_image_stack[:stacklength]
  label_stack = label_stack[:stacklength]

  downscale = raw_image_stack.shape[1] / label_stack.shape[1]

  readout_time = None
  for v in metadata['metadata'].values():
    if 'ADF readouttime' in v:
      readout_time = v['ADF readouttime']
      break
  if readout_time is None:
    raise ValueError('Required ADF readouttime information not present.')

  coordinates, parameters = {}, {}
  for frame, val in metadata['metadata'].items():
    c = coordinates[frame] = {}
    p = parameters[frame] = {}
    c['label'] = np.asarray(val['All coordinates']['0'])
    c['image'] = downscale * c['label']
    p['readout_time'] = readout_time
    p['FOV'] = val['All parameters']['image_parameters'][0]
    try:
      c['dopant'] = downscale * np.asarray(
          val['Blast coordinates']['Dopants']
      )
      c['beam loc'] = downscale * np.asarray(
          val['Beam location']
      ).reshape(-1, 2)
      p['beam dwelltime'] = val['Beam dwelltime']
      p['pixelshifts'] = np.asarray(val['Pixelshifts'])
    except KeyError:
      c['dopant'] = np.full((1, 2), np.nan)
      c['beam loc'] = np.full((1, 2), np.nan)
      p['beam dwelltime'] = np.nan
      p['pixelshifts'] = np.asarray([0, 0])
  return raw_image_stack, coordinates, parameters


def convert_dataset(
    raw_image_stack: np.ndarray,
    coordinates: Dict[str, Any],
    parameters: Dict[str, Any],
) -> md.Trajectory:
  """ORNL arrays -> Trajectory."""
  length = raw_image_stack.shape[0]
  fov_nm = parameters['0']['FOV']
  corners = np.stack([[0.0, 0.0], [10 * fov_nm, 10 * fov_nm]], axis=0)
  observations = []
  for t in range(length):
    key = str(t)
    fov_nm = parameters[key]['FOV']
    rescale = np.asarray(raw_image_stack.shape[1:3], np.float64)
    grid_pos = coordinates[key]['image'][:, :2] / rescale
    atomic_numbers = np.full(grid_pos.shape[0], 6, np.int32)
    if len(coordinates) <= 3:
      break
    dopants = coordinates[key]['dopant'] / rescale
    for dopant in np.atleast_2d(dopants):
      if np.isnan(dopant).any():
        continue
      dists = np.linalg.norm(grid_pos - dopant, axis=-1)
      atomic_numbers[dists < 1e-6] = 14

    shift = 10 * fov_nm * parameters[key]['pixelshifts'] / rescale
    corners = corners + shift
    fov = md.MicroscopeFieldOfView(corners[0], corners[1])

    dwell = parameters[key]['beam dwelltime']
    if np.isnan(dwell):
      controls = ()
      elapsed = dt.timedelta(seconds=2.0)
    else:
      beam = coordinates[key]['beam loc'][0] / rescale
      controls = (
          md.BeamControl(beam, dt.timedelta(seconds=float(dwell))),
      )
      elapsed = dt.timedelta(seconds=float(dwell) + 2.0)

    observations.append(
        md.MicroscopeObservation(
            grid=md.AtomicGrid(grid_pos, atomic_numbers),
            fov=fov,
            controls=controls,
            elapsed_time=elapsed,
            image=raw_image_stack[t],
        )
    )
  return md.Trajectory(tuple(observations))


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--directory', required=True)
  parser.add_argument('--output_dir', required=True)
  parser.add_argument(
      '--output_format',
      default='tfrecords',
      choices=('tfrecords', 'riegeli'),
      help='Record format; riegeli is what upstream putting-dune uploads.',
  )
  parser.add_argument(
      '--image_format',
      default='ndarray',
      choices=('ndarray', 'tensorproto'),
      help=('On-wire image encoding: ndarray, or tensorproto '
            '(tensorflow.TensorProto, as upstream putting-dune writes).'),
  )
  args = parser.parse_args(argv)

  root = pathlib.Path(args.directory)
  paths = [leaf.parent for leaf in root.rglob('**/ADF-stack-000.ndata1')]
  if not paths:
    print(f'No microscope datasets found in {root}', file=sys.stderr)
    sys.exit(1)

  os.makedirs(args.output_dir, exist_ok=True)
  for dataset_path in paths:
    name = '-'.join(dataset_path.relative_to(root).parts) or 'dataset'
    out = os.path.join(args.output_dir, f'{name}.{args.output_format}')
    try:
      trajectory = convert_dataset(*load_dataset(dataset_path))
    except (ValueError, KeyError) as e:
      print(f'Failed to load {dataset_path}: {e}', file=sys.stderr)
      continue
    with md.image_wire_format(args.image_format):
      records.write_records(out, [trajectory])
    print(f'{dataset_path} -> {out}')


if __name__ == '__main__':
  main()
