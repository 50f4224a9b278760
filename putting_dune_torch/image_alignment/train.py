"""Loading a trained image aligner's artifacts.

Port of `load_arch` and the `params.msgpack` branch of `load_params` of
putting_dune_tpu/image_alignment/train.py. The trainer and its data
(`data.py`) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

from putting_dune_torch.atom_detection import train as detector_train


def load_arch(workdir: str) -> Optional[dict]:
  """Reads the arch.json sidecar ({'features', 'num_frames', 'image_size'})
  if present."""
  return detector_train.load_arch(workdir)


def load_params(workdir: str) -> dict:
  """The flax parameter tree in `workdir`/params.msgpack, as nested dicts
  of float32 numpy arrays."""
  return detector_train.load_params(workdir)
