"""The image aligner, the classical alignment and the pipeline converters
of putting_dune_torch against the JAX package, on the CPU.

The shipped aligner (model_weights/image_aligner: features (64, 128, 256,
512), 5 frames, 128^2) runs in both packages on one 12-frame drifting
sequence rendered by the port's simulator at 0.5 A per frame per axis.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import microscope_data as t_md
from putting_dune_torch import microscope_agent as t_ma
from putting_dune_torch.alignment import classical as t_classical
from putting_dune_torch.image_alignment import inference as t_inference
from putting_dune_torch.image_alignment import model as t_model
from putting_dune_torch.image_alignment import train as t_train
from putting_dune_torch.pipeline import align_trajectories as t_align
from putting_dune_torch.pipeline import trajectories_to_transitions as t_t2t
from putting_dune_tpu import microscope_data as j_md
from putting_dune_tpu.alignment import classical as j_classical
from putting_dune_tpu.image_alignment import inference as j_inference
from putting_dune_tpu.image_alignment import model as j_model
from putting_dune_tpu.pipeline import align_trajectories as j_align
from putting_dune_tpu.pipeline import trajectories_to_transitions as j_t2t

torch.set_num_threads(4)

WEIGHTS = t_inference.SHIPPED_ALIGNER_DIR
NUM_FRAMES = 12
# Drifts of the two packages differ by float32 rounding in the UNet
# (~3e-7 A measured); detections and claims must be equal.
DRIFT_TOL = 1e-5


@pytest.fixture(scope='module')
def params():
  return t_train.load_params(WEIGHTS)


@pytest.fixture(scope='module')
def jax_aligner(params):
  """The JAX ImageAligner on the shipped params, built once per module."""
  arch = t_train.load_arch(WEIGHTS)
  return j_inference.ImageAligner(
      jax.tree_util.tree_map(jnp.asarray, params),
      features=tuple(arch['features']), history_length=arch['num_frames'])


@pytest.fixture(scope='module')
def torch_aligner():
  return t_inference.ImageAligner.from_checkpoint(device='cpu')


@pytest.fixture(scope='module')
def sequence():
  """(images, (lower_left, upper_right) claims, true cumulative drifts) of
  a drifting microscope that barely moves its silicon."""
  observations, drifts = t_ma.drifting_sequence(11, NUM_FRAMES, device='cpu')
  return ([o.image for o in observations],
          [(o.fov.lower_left, o.fov.upper_right) for o in observations],
          drifts)


def _points(grid):
  return sorted(map(tuple, np.round(grid.atom_positions, 9).tolist()))


def _claims(aligner):
  return np.stack([np.concatenate([f.lower_left, f.upper_right])
                   for f in aligner.fov_history])


def test_aligner_markers_are_read_as_the_jax_tests_read_them():
  assert t_inference.has_marker(WEIGHTS, t_inference.LABELS_CUMULATIVE)
  assert t_inference.has_marker(WEIGHTS, t_inference.REGISTRATION_TRAINED)
  assert not t_inference.has_marker(WEIGHTS, 'NO_SUCH_MARKER')
  assert t_train.load_arch(WEIGHTS) == {
      'features': [64, 128, 256, 512], 'num_frames': 5, 'image_size': 128}


def test_global_local_unet_matches_flax(params):
  x = np.random.default_rng(0).uniform(size=(1, 128, 128, 5)).astype(
      np.float32)
  module = j_model.GlobalLocalUNet(local_output_size=15,
                                   global_output_size=10,
                                   features=(64, 128, 256, 512))
  want_local, want_global = module.apply(
      {'params': jax.tree_util.tree_map(jnp.asarray, params)},
      jnp.asarray(x))
  with torch.no_grad():
    got_local, got_global = t_model.from_flax(params)(torch.from_numpy(x))
  np.testing.assert_allclose(got_local.numpy(), np.asarray(want_local),
                             atol=1e-4)
  np.testing.assert_allclose(got_global.numpy(), np.asarray(want_global),
                             atol=1e-4)


def test_image_aligner_matches_jax_over_a_drifting_sequence(
    jax_aligner, torch_aligner, sequence):
  images, fovs, _ = sequence
  jax_aligner.reset()
  torch_aligner.reset()
  for image, (ll, ur) in zip(images, fovs):
    j_grid, j_drift, j_probs = jax_aligner(image,
                                           j_md.MicroscopeFieldOfView(ll, ur))
    t_grid, t_drift, t_probs = torch_aligner(
        image, t_md.MicroscopeFieldOfView(ll, ur))
    np.testing.assert_allclose(t_drift, j_drift, atol=DRIFT_TOL)
    np.testing.assert_allclose(torch_aligner.last_drifts,
                               np.asarray(jax_aligner.last_drifts),
                               atol=DRIFT_TOL)
    np.testing.assert_allclose(t_probs, np.asarray(j_probs), atol=1e-4)
    assert _points(t_grid) == _points(j_grid)
    np.testing.assert_array_equal(t_grid.atomic_numbers[
        np.lexsort(np.round(t_grid.atom_positions, 9).T[::-1])],
                                  j_grid.atomic_numbers[np.lexsort(
                                      np.round(j_grid.atom_positions,
                                               9).T[::-1])])
    # The history claims move together through amend and refine.
    jax_aligner.amend_last_fov(j_md.MicroscopeFieldOfView(ll, ur).shift(
        -np.asarray(j_drift)))
    torch_aligner.amend_last_fov(t_md.MicroscopeFieldOfView(ll, ur).shift(
        -t_drift))
    jax_aligner.refine_history_claims()
    torch_aligner.refine_history_claims()
    np.testing.assert_allclose(_claims(torch_aligner), _claims(jax_aligner),
                               atol=4 * DRIFT_TOL)


def test_compute_centroids_equal_jax_on_the_same_classes():
  rng = np.random.default_rng(3)
  for _ in range(5):
    probs = rng.dirichlet(np.ones(3) * 0.3, size=(128, 128)).astype(
        np.float32)
    t_grid = t_inference.ImageAligner.process_detection_predictions(probs)
    j_grid = j_inference.ImageAligner.process_detection_predictions(probs)
    assert _points(t_grid) == _points(j_grid)


def test_hybrid_aligner_runs(sequence):
  aligner = t_inference.ImageAligner.from_checkpoint(
      device='cpu', hybrid=True, seed=0)
  images, fovs, _ = sequence
  for image, (ll, ur) in zip(images[:4], fovs[:4]):
    grid, drift, probs = aligner(image, t_md.MicroscopeFieldOfView(ll, ur))
    assert np.isfinite(drift).all() and drift.shape == (2,)
    assert grid.num_atoms > 0 and np.isfinite(grid.atom_positions).all()
    assert probs.shape == (128, 128, 3)
  assert aligner.postprocessing_aligner.step >= 1


def _trajectories(md, sequence, grid_numbers=(6, 14)):
  images, fovs, _ = sequence
  grid = md.AtomicGrid(np.asarray([[0.2, 0.3], [0.5, 0.5]]),
                       np.asarray(grid_numbers))
  observations = []
  for t, (image, (ll, ur)) in enumerate(zip(images, fovs)):
    controls = () if t == 0 else (md.BeamControl(
        np.asarray([0.5, 0.5 + 0.01 * t]), dt.timedelta(seconds=1.5)),)
    observations.append(md.MicroscopeObservation(
        grid=grid, fov=md.MicroscopeFieldOfView(ll, ur), controls=controls,
        elapsed_time=dt.timedelta(seconds=float(t)), image=image))
  return md.Trajectory(tuple(observations))


def test_do_alignment_matches_jax_and_tracks_the_drift(
    jax_aligner, torch_aligner, sequence):
  images, fovs, true_drift = sequence
  j_out = j_align.do_alignment(
      _trajectories(j_md, sequence),
      j_align.Args(source_path='', target_path='', aligner_workdir=WEIGHTS),
      jax_aligner)
  t_out = t_align.do_alignment(
      _trajectories(t_md, sequence),
      t_align.Args(source_path='', target_path='', aligner_workdir=WEIGHTS),
      torch_aligner)
  j_ll = np.stack([o.fov.lower_left for o in j_out.observations])
  t_ll = np.stack([o.fov.lower_left for o in t_out.observations])
  np.testing.assert_allclose(t_ll, j_ll, atol=1e-4)
  # The JAX test's increment bar: per-frame drift tracked to 0.35 A on
  # average. (Its other bar, the last three frames below 0.8x the
  # uncorrected error, holds on only 0.29 of the JAX package's own
  # sequences, seeds 0-23 of `scripts/rehearsal_pair.py --alignment`, so
  # one sequence does not test it.)
  believed = np.stack([ll for ll, _ in fovs])
  recovered = t_ll - believed
  inc_err = np.linalg.norm(
      np.diff(-recovered, axis=0) - np.diff(true_drift, axis=0), axis=1)
  assert np.linalg.norm(true_drift, axis=1)[-3:].mean() > 0.8
  assert inc_err.mean() < 0.35


def test_trajectories_to_transitions_matches_jax(sequence):
  for previous in (False, True):
    j_out = j_t2t.trajectories_to_transitions(
        [_trajectories(j_md, sequence)] * 2,
        previous_controls_at_current_timestep=previous)
    t_out = t_t2t.trajectories_to_transitions(
        [_trajectories(t_md, sequence)] * 2,
        previous_controls_at_current_timestep=previous)
    assert len(t_out) == len(j_out) == 2 * (NUM_FRAMES - 1)
    for a, b in zip(t_out, j_out):
      np.testing.assert_array_equal(a.fov_before.lower_left,
                                    b.fov_before.lower_left)
      np.testing.assert_array_equal(a.fov_after.upper_right,
                                    b.fov_after.upper_right)
      assert len(a.controls) == len(b.controls)
      for ca, cb in zip(a.controls, b.controls):
        np.testing.assert_array_equal(ca.position, cb.position)
        assert ca.dwell_time == cb.dwell_time
      np.testing.assert_array_equal(a.image_after, b.image_after)


# --- classical ---------------------------------------------------------------


def _lattice_points(rng, n_cols=8, noise=0.02):
  a = 1.42
  pts = []
  for i in range(n_cols):
    for j in range(n_cols):
      base = np.asarray([i * 1.5 * a, j * np.sqrt(3) * a + (i % 2) *
                         np.sqrt(3) / 2 * a])
      pts.append(base)
      pts.append(base + np.asarray([a, 0.0]))
  pts = np.asarray(pts)
  return pts + rng.normal(size=pts.shape) * noise


@pytest.mark.parametrize('case', range(6))
def test_pad_and_crop_images_by_fov_matches_jax(case):
  rng = np.random.default_rng(case)
  image = rng.uniform(size=(128, 128, 1)).astype(np.float32)
  original = (np.asarray([0.0, 0.0]), np.asarray([20.0, 20.0]))
  shift = rng.uniform(-4, 4, 2)
  scale = (1.0, 0.8, 1.25, 1.0, 0.9, 1.1)[case]
  new = (original[0] + shift, original[0] + shift + 20.0 * scale)
  want = j_classical.pad_and_crop_images_by_fov(
      image, j_md.MicroscopeFieldOfView(*original),
      j_md.MicroscopeFieldOfView(*new))
  got = t_classical.pad_and_crop_images_by_fov(
      image, t_md.MicroscopeFieldOfView(*original),
      t_md.MicroscopeFieldOfView(*new))
  np.testing.assert_array_equal(got, want)


def test_classical_point_functions_match_jax():
  rng = np.random.default_rng(5)
  pts = _lattice_points(rng)
  assert t_classical.get_graphene_scale_factor(pts) == pytest.approx(
      j_classical.get_graphene_scale_factor(pts), abs=1e-12)
  moved = pts + np.asarray([0.3, -0.2]) + rng.normal(size=pts.shape) * 0.01
  for mask_above in (np.inf, 0.5):
    np.testing.assert_array_equal(
        t_classical.get_offsets(moved, pts, mask_above),
        j_classical.get_offsets(moved, pts, mask_above))
  classes = (np.arange(len(pts)) % 2).astype(np.int32)
  for trim in (0.0, 0.5):
    np.testing.assert_allclose(
        t_classical.align_latest(moved, pts, classes, classes, trim=trim,
                                 mask_above=2.0),
        j_classical.align_latest(moved, pts, classes, classes, trim=trim,
                                 mask_above=2.0), atol=1e-12)
  # Annealing noise from one generator each, seeded alike.
  np.testing.assert_allclose(
      t_classical.align_latest(moved, pts, classes, classes, noise_scale=0.1,
                               rng=np.random.default_rng(1)),
      j_classical.align_latest(moved, pts, classes, classes, noise_scale=0.1,
                               rng=np.random.default_rng(1)), atol=1e-12)
  batches = [pts, moved, pts[::2] + 0.05]
  for got, want in zip(t_classical.naive_merge(batches, 0.7),
                       j_classical.naive_merge(batches, 0.7)):
    np.testing.assert_allclose(got, want, atol=1e-12)
  np.testing.assert_array_equal(
      t_classical.propagate_atomic_numbers(
          moved, pts, np.where(classes == 1, 14, 6)),
      j_classical.propagate_atomic_numbers(
          moved, pts, np.where(classes == 1, 14, 6)))
  np.testing.assert_array_equal(
      t_classical.propagate_graphene_classes(classes, pts),
      j_classical.propagate_graphene_classes(classes, pts))


def test_clique_merge_matches_jax_as_sets():
  rng = np.random.default_rng(2)
  pts = np.concatenate([_lattice_points(rng, 5),
                        _lattice_points(rng, 5) + 0.3])
  for cutoff in (0.5, 0.71, 1.0):
    t_coords, t_counts = t_classical.clique_merge(pts, cutoff)
    j_coords, j_counts = j_classical.clique_merge(pts, cutoff)
    key = lambda c, n: sorted(  # noqa: E731
        zip(np.round(c, 9).tolist(), np.asarray(n).tolist()))
    assert key(t_coords, t_counts) == key(j_coords, j_counts)


def test_lattice_two_colouring_matches_jax_up_to_a_swap():
  rng = np.random.default_rng(4)
  pts = _lattice_points(rng, 7, noise=0.05)
  t_labels = t_classical.classify_lattice_types(
      pts, t_classical.get_lattice_clusterer(pts, np.random.default_rng(0)))
  j_labels = j_classical.classify_lattice_types(
      pts, j_classical.get_lattice_clusterer(pts))
  assert (np.array_equal(t_labels, j_labels)
          or np.array_equal(t_labels, 1 - j_labels))
  # The two sublattices: each atom's nearest neighbours are of the other.
  d = np.linalg.norm(pts[:, None] - pts[None], axis=-1) + np.eye(len(pts)) * 9
  nearest = d.argmin(-1)
  interior = (d < 1.6).sum(-1) >= 3
  assert (t_labels[interior] != t_labels[nearest][interior]).all()


def test_iterative_alignment_filtering_matches_jax():
  rng = np.random.default_rng(6)
  base = _lattice_points(rng, 6, noise=0.0)
  t_filter = t_classical.IterativeAlignmentFiltering(
      history_length=3, alignment_iterations=10, seed=0)
  j_filter = j_classical.IterativeAlignmentFiltering(
      history_length=3, alignment_iterations=10)
  for step in range(4):
    frame = base + np.asarray([0.1, -0.05]) * step + rng.normal(
        size=base.shape) * 0.02
    numbers = np.full(len(frame), 6)
    numbers[7] = 14
    t_grid, t_drift = t_filter(t_md.AtomicGrid(frame, numbers))
    j_grid, j_drift = j_filter(j_md.AtomicGrid(frame, numbers))
    np.testing.assert_allclose(t_drift, j_drift, atol=1e-9)
    np.testing.assert_allclose(t_grid.atom_positions, j_grid.atom_positions,
                               atol=1e-9)
    np.testing.assert_array_equal(t_grid.atomic_numbers,
                                  j_grid.atomic_numbers)
