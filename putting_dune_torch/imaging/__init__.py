"""Synthetic STEM imaging: Gaussian-splat rendering + fused noise chain."""

from putting_dune_torch.imaging.params import sample_imaging_params
from putting_dune_torch.imaging.render import (
    render_clean_image,
    render_stem_image,
)

__all__ = [
    'sample_imaging_params',
    'render_clean_image',
    'render_stem_image',
]
