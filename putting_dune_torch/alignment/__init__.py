"""Drift correction and atom-cloud alignment (classical + learned)."""

from putting_dune_torch.alignment.classical import (
    IterativeAlignmentFiltering,
    align_latest,
    classify_lattice_types,
    clique_merge,
    get_graphene_scale_factor,
    get_lattice_clusterer,
    get_offsets,
    naive_merge,
    pad_and_crop_images_by_fov,
    propagate_atomic_numbers,
    propagate_graphene_classes,
)

__all__ = [
    'IterativeAlignmentFiltering',
    'align_latest',
    'classify_lattice_types',
    'clique_merge',
    'get_graphene_scale_factor',
    'get_lattice_clusterer',
    'get_offsets',
    'naive_merge',
    'pad_and_crop_images_by_fov',
    'propagate_atomic_numbers',
    'propagate_graphene_classes',
]
