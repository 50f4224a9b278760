"""Learned image alignment: joint segmentation + drift regression."""

from putting_dune_torch.image_alignment.model import GlobalLocalUNet
from putting_dune_torch.image_alignment.inference import ImageAligner

__all__ = ['GlobalLocalUNet', 'ImageAligner']
