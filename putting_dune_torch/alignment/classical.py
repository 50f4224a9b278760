"""Classical (non-learned) drift correction and point-cloud merging.

Port of putting_dune_tpu/alignment/classical.py in numpy and scipy: scale
estimation, closest-point offsets, ICP with annealing, trimming and class
masks, clique and naive merging, FOV-based image crops, atomic-number
propagation, the lattice two-colouring and the IterativeAlignmentFiltering
history pipeline. These run on ragged point clouds on the host.

Two replacements for the JAX package's libraries: the 2-means of the
two-colouring is `scipy.cluster.vq.kmeans2` with k-means++ seeding on a
seeded generator (sklearn's KMeans there; both are random, so labels agree
only up to a swap), and the maximal cliques of `clique_merge` are found by
Bron-Kerbosch with pivoting (networkx's find_cliques there; the same set
of cliques, in another order).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.cluster.vq
import scipy.spatial
import scipy.stats

from putting_dune_torch import constants
from putting_dune_torch import microscope_data as md
from putting_dune_torch.imaging import morphology


def get_graphene_scale_factor(coordinates: np.ndarray) -> float:
  """Trimmed-mean bond length relative to 1.42 A."""
  d = np.linalg.norm(
      coordinates[:, None] - coordinates[None], axis=-1
  )
  d = np.sort(d, axis=-1)
  neighbor_distances = d[:, 1:4].reshape(-1)
  estimate = scipy.stats.trim_mean(neighbor_distances, 0.25)
  return float(estimate / constants.CARBON_BOND_DISTANCE_ANGSTROMS)


def get_offsets(
    left_coords: np.ndarray,
    right_coords: np.ndarray,
    mask_above: float = np.inf,
) -> np.ndarray:
  """Closest-point offsets left->right, optionally masked."""
  d = np.linalg.norm(
      left_coords[:, None] - right_coords[None], axis=-1
  )
  closest = d.argmin(-1)
  closest_d = d[np.arange(len(closest)), closest]
  offsets = right_coords[closest] - left_coords
  return offsets[closest_d < mask_above]


def align_latest(
    new_coordinates: np.ndarray,
    reference_coordinates: np.ndarray,
    new_classes: np.ndarray,
    reference_classes: np.ndarray,
    iterations: int = 20,
    noise_scale: float = 0.0,
    max_shift: float = 2.0,
    mask_above: float = np.inf,
    trim: float = 0.0,
    init_shift: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
  """ICP shift estimation with annealing noise and class-matched pairs.

  Returns a shift such that
  new_coordinates + shift ~ reference_coordinates.
  """
  rng = rng or np.random.default_rng()
  shift = (
      np.zeros(new_coordinates.shape[-1])
      if init_shift is None
      else np.asarray(init_shift, np.float64).copy()
  )
  noise_scales = np.linspace(noise_scale, 0.0, num=iterations)
  class_values = sorted(set(np.asarray(new_classes).tolist()))
  masks = [(new_classes == c) for c in class_values]
  ref_masks = [(reference_classes == c) for c in class_values]

  for i in range(iterations):
    ns = noise_scales[i]
    noise = rng.normal(size=(2,)) * ns if ns > 0 else np.zeros(2)
    current = new_coordinates + shift + noise
    offsets = np.concatenate(
        [
            get_offsets(current[m], reference_coordinates[rm], mask_above)
            for m, rm in zip(masks, ref_masks)
        ]
    )
    if trim > 0:
      order = np.argsort(np.linalg.norm(offsets, axis=-1))
      offsets = offsets[order[: int((1 - trim) * len(offsets))]]
    shift += noise + offsets.mean(axis=0)
    norm = np.linalg.norm(shift)
    if norm > max_shift:
      shift *= max_shift / norm
  return shift


def maximal_cliques(num_nodes: int, edges: np.ndarray) -> List[List[int]]:
  """Every maximal clique of the undirected graph on `num_nodes` nodes with
  (E, 2) `edges`, isolated nodes as 1-cliques (Bron-Kerbosch with
  pivoting)."""
  adjacency = [set() for _ in range(num_nodes)]
  for a, b in np.asarray(edges, np.int64).reshape(-1, 2):
    if a != b:
      adjacency[a].add(int(b))
      adjacency[b].add(int(a))
  cliques = []
  stack = [([], set(range(num_nodes)), set())]
  while stack:
    clique, candidates, excluded = stack.pop()
    if not candidates and not excluded:
      cliques.append(clique)
      continue
    pivot = max(candidates | excluded, key=lambda u: len(adjacency[u]
                                                         & candidates))
    for v in sorted(candidates - adjacency[pivot]):
      stack.append((clique + [v], candidates & adjacency[v],
                    excluded & adjacency[v]))
      candidates = candidates - {v}
      excluded = excluded | {v}
  return cliques


def clique_merge(
    coordinates: np.ndarray,
    min_distance: float = 1.0,
    max_iterations: int = 100,
    counts: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
  """Merges clusters of nearby points via graph cliques.

  Each clique of points within min_distance collapses to its count-weighted
  mean; repeats until no pair is closer than min_distance.
  """
  if counts is None:
    counts = np.ones(coordinates.shape[0])
  for _ in range(max_iterations):
    tree = scipy.spatial.cKDTree(coordinates)
    close = tree.query_pairs(r=min_distance, output_type='ndarray')
    if not close.shape[0]:
      return coordinates, counts
    cliques = maximal_cliques(len(coordinates), close)
    coordinates = np.stack(
        [
            np.sum(
                coordinates[c] * counts[c, None] / np.sum(counts[c]), axis=0
            )
            for c in cliques
        ],
        0,
    )
    counts = np.asarray([np.sum(counts[c]) for c in cliques])
  return coordinates, counts


def naive_merge(
    coordinates: Sequence[np.ndarray], cutoff: float = 0.7
) -> Tuple[np.ndarray, np.ndarray]:
  """Sequentially folds point sets into running means."""
  coordinates = [np.asarray(c, np.float64) for c in coordinates if len(c)]
  positions = coordinates[0].copy()
  counts = np.ones(positions.shape[0])

  for batch in coordinates[1:]:
    extra = []
    d = np.linalg.norm(batch[None] - positions[:, None], axis=-1)
    closest = d.argmin(0)
    for i, target in enumerate(closest):
      if d[target, i] < cutoff:
        positions[target] = (
            positions[target] * counts[target] + batch[i]
        ) / (counts[target] + 1)
        counts[target] += 1
      else:
        extra.append(batch[i])
    if extra:
      positions = np.concatenate([positions, np.stack(extra)], 0)
      counts = np.concatenate([counts, np.ones(len(extra))], 0)
  return positions, counts


def pad_and_crop_images_by_fov(
    image: np.ndarray,
    original_fov: md.MicroscopeFieldOfView,
    new_fov: md.MicroscopeFieldOfView,
) -> np.ndarray:
  """Extracts the sub-image a new FOV would see.

  Pads with zeros where the new FOV extends beyond the original image.
  """
  if image.ndim == 2:
    image = image[..., None]

  original_scale = original_fov.upper_right - original_fov.lower_left
  new_scale = new_fov.upper_right - new_fov.lower_left
  resize_factor = original_scale / new_scale

  output_shape = image.shape
  image_hw = np.asarray(output_shape[:-1])

  if (resize_factor != 1).any():
    new_size = np.round(image_hw * resize_factor).astype(np.int32)
    resized = morphology.resize_nearest(
        image, int(new_size[0]), int(new_size[1]))
  else:
    resized = image

  pad_h, pad_w = output_shape[0], output_shape[1]
  padded = np.pad(
      resized, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)), mode='constant'
  )

  # Image origin is the upper-left: x from lower-left, y from upper-right,
  # with the y axis flipped.
  x_shift = new_fov.lower_left[0] - original_fov.lower_left[0]
  y_shift = new_fov.upper_right[1] - original_fov.upper_right[1]
  shift = np.asarray([-y_shift, x_shift]) * image_hw / new_scale[::-1]

  start = shift + np.asarray([pad_h, pad_w])
  start[0] = np.clip(start[0], 0, padded.shape[0] - output_shape[0])
  start[1] = np.clip(start[1], 0, padded.shape[1] - output_shape[1])
  start = np.round(start).astype(np.int32)

  return padded[
      start[0]:start[0] + output_shape[0],
      start[1]:start[1] + output_shape[1],
  ]


def propagate_atomic_numbers(
    original_atom_positions: np.ndarray,
    merged_atom_positions: np.ndarray,
    original_atomic_numbers: np.ndarray,
    new_atomic_numbers: Optional[np.ndarray] = None,
    default_atomic_number: int = constants.CARBON,
    threshold: float = 0.8,
) -> np.ndarray:
  """Transfers species labels to merged positions."""
  d = np.linalg.norm(
      original_atom_positions[:, None] - merged_atom_positions[None], axis=-1
  )
  closest = d.argmin(-1)
  keep = d.min(-1) < threshold
  if new_atomic_numbers is None:
    new_atomic_numbers = np.full(
        merged_atom_positions.shape[0],
        default_atomic_number,
        dtype=np.asarray(original_atomic_numbers).dtype,
    )
  else:
    new_atomic_numbers = np.asarray(new_atomic_numbers).copy()
  new_atomic_numbers[closest[keep]] = np.asarray(original_atomic_numbers)[
      keep
  ]
  return new_atomic_numbers


# --- lattice two-coloring ------------------------------------------------------


def _neighbor_angles(grid: np.ndarray, exclude_self: bool) -> np.ndarray:
  """Angles to each atom's 3 nearest neighbors."""
  centered = grid[:, :2] - grid[:, :2].mean(0, keepdims=True)
  d = np.linalg.norm(centered[None] - centered[:, None], axis=-1)
  if exclude_self:
    d = d + np.eye(d.shape[0]) * 1000.0
    neighbors = np.argsort(d, axis=-1)[:, :3]
  else:
    neighbors = np.argsort(d, axis=-1)[:, 1:4]
  rel = centered[neighbors] - centered[:, None]
  return np.arctan2(rel[..., 1], rel[..., 0])


def _sublattice_features(angles: np.ndarray) -> np.ndarray:
  """Continuous sublattice signature from bond angles.

  The two graphene sublattices have bond stars offset by 60 degrees, so the
  third angular harmonic mean((cos 3a, sin 3a)) maps them to antipodal
  points on the unit circle — a featurization that is continuous (no +-pi
  wraparound), permutation-invariant, and noise-robust. The upstream code
  clusters raw (sorted-at-fit, unsorted-at-predict) angle vectors
  (alignment.py:849, :890), which is discontinuous at +-pi and inconsistent
  between fit and predict; this is the framework's deliberate fix.
  """
  return np.stack(
      [np.cos(3.0 * angles).mean(-1), np.sin(3.0 * angles).mean(-1)],
      axis=-1,
  )


class TwoMeans:
  """Two centroids; `predict` labels each row by the nearer one."""

  def __init__(self, centroids: np.ndarray):
    self.cluster_centers_ = np.asarray(centroids)

  def predict(self, features: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(
        features[:, None] - self.cluster_centers_[None], axis=-1)
    return d.argmin(-1).astype(np.int32)


def get_lattice_clusterer(grid: np.ndarray,
                          rng: Optional[np.random.Generator] = None
                          ) -> TwoMeans:
  """2-means over sublattice bond-angle signatures (k-means++ seeding from
  `rng`, a fresh generator if None)."""
  rng = rng or np.random.default_rng()
  features = _sublattice_features(
      _neighbor_angles(grid, exclude_self=False)
  )
  centroids, _ = scipy.cluster.vq.kmeans2(
      features, 2, minit='++', seed=rng, missing='warn')
  return TwoMeans(centroids)


def classify_lattice_types(grid: np.ndarray, clusters: TwoMeans
                           ) -> np.ndarray:
  """Labels atoms by sublattice, then fixes edge atoms."""
  features = _sublattice_features(
      _neighbor_angles(grid, exclude_self=True)
  )
  classes = clusters.predict(features)
  return propagate_graphene_classes(classes, grid)


def propagate_graphene_classes(
    classes: np.ndarray, grid: np.ndarray
) -> np.ndarray:
  """Frontier-propagates the two-coloring to low-degree edge atoms.

  Atoms with < 3 in-radius neighbors get the
  complement of their classified neighbors' majority label, iterating
  outward until fixed.
  """
  classes = np.asarray(classes).copy()
  centered = grid[:, :2] - grid[:, :2].mean(0, keepdims=True)
  d = np.linalg.norm(centered[None] - centered[:, None], axis=-1)
  d = d + np.eye(d.shape[0]) * 1000.0
  neighbor_dists = np.sort(d, axis=-1)
  neighbor_mask = d < neighbor_dists[:, :3].mean() * 1.1
  degrees = neighbor_mask.sum(-1)
  classified = degrees >= 3

  while True:
    filtered = neighbor_mask.copy()
    filtered[:, ~classified] = False
    frontier = ~classified & (filtered.sum(-1) >= 1)
    if frontier.sum() == 0:
      return classes
    neighbor_classes = filtered[frontier] * classes[None]
    num_neighbors = filtered[frontier].sum(-1)
    new_classes = 1 - neighbor_classes.sum(-1) / num_neighbors
    classes[frontier] = np.nan_to_num(np.round(new_classes), nan=0.0)
    classified[frontier] = True


class IterativeAlignmentFiltering:
  """History-based ICP alignment + merge pipeline.

  Keeps a rolling history of recent atom clouds; each new observation is
  ICP-aligned against the accumulated history (with sublattice-class
  matching), merged with it, and species labels are propagated onto the
  merged cloud. `seed` seeds the generator of the 2-means and the ICP's
  annealing noise (fresh entropy if None).
  """

  def __init__(
      self,
      history_length: int = 10,
      alignment_iterations: int = 20,
      noise_scale: float = 0.0,
      max_shift: float = 2.0,
      merge_cutoff: float = 1.1,
      accumulate_merged: bool = False,
      clique_merging: bool = False,
      trim: float = 0.0,
      seed: Optional[int] = None,
  ):
    self._rng = np.random.default_rng(seed)
    self.history_length = history_length
    self.alignment_iterations = alignment_iterations
    self.noise_scale = noise_scale
    self.max_shift = max_shift
    self.merge_cutoff = merge_cutoff
    self.accumulate_merged = accumulate_merged
    self.clique_merging = clique_merging
    self.trim = trim
    self.reset()

  def reset(self) -> None:
    self.recent_observations: List[np.ndarray] = []
    self.recent_classes: List[np.ndarray] = []
    self.classifier = None
    self.step = 0

  def apply_shift(self, shift: np.ndarray) -> None:
    """Shifts the whole history (for external FOV moves)."""
    self.recent_observations = [
        obs + shift for obs in self.recent_observations
    ]

  def __call__(
      self, new_observation: md.AtomicGrid
  ) -> Tuple[md.AtomicGrid, np.ndarray]:
    """Aligns + merges a new material-frame grid; returns (grid, -drift)."""
    self.step += 1
    positions = new_observation.atom_positions
    if not self.recent_observations:
      self.recent_observations.append(positions)
      self.classifier = get_lattice_clusterer(positions, self._rng)
      self.recent_classes.append(
          classify_lattice_types(positions, self.classifier)
      )
      return new_observation, np.zeros(2)

    classes = classify_lattice_types(positions, self.classifier)
    drift = align_latest(
        positions,
        np.concatenate(self.recent_observations),
        classes,
        np.concatenate(self.recent_classes),
        iterations=self.alignment_iterations,
        noise_scale=self.noise_scale,
        max_shift=self.max_shift,
        mask_above=2.0,
        init_shift=np.zeros(2),
        trim=self.trim,
        rng=self._rng,
    )
    shifted = positions + drift

    to_merge = list(self.recent_observations) + [shifted]
    if self.clique_merging:
      joined, _ = clique_merge(
          np.concatenate(to_merge, 0), self.merge_cutoff
      )
    else:
      joined, _ = naive_merge(to_merge, self.merge_cutoff)

    if self.accumulate_merged:
      self.recent_observations.append(joined)
      self.recent_classes.append(
          classify_lattice_types(joined, self.classifier)
      )
    else:
      self.recent_observations.append(shifted)
      self.recent_classes.append(classes)
    if len(self.recent_observations) > self.history_length:
      cut = len(self.recent_observations) - self.history_length
      self.recent_observations = self.recent_observations[cut:]
      self.recent_classes = self.recent_classes[cut:]

    numbers = propagate_atomic_numbers(
        shifted, joined, new_observation.atomic_numbers
    )
    return md.AtomicGrid(joined, numbers), -drift
