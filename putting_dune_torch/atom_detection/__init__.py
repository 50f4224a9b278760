"""Atom detection: UNet semantic segmentation of STEM images."""

from putting_dune_torch.atom_detection.model import UNet
from putting_dune_torch.atom_detection.inference import AtomDetector

__all__ = ['UNet', 'AtomDetector']
