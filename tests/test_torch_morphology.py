"""putting_dune_torch/imaging/morphology.py against OpenCV, exactly.

The JAX package post-processes its aligner and detector with cv2; the port
does without it. Every helper must give cv2's answer bit for bit.
"""

import cv2
import numpy as np
import pytest

from putting_dune_torch.imaging import morphology

KERNEL = np.ones((2, 2))


def _cv2_centroids(binary):
  contours, _ = cv2.findContours(binary, cv2.RETR_LIST,
                                 cv2.CHAIN_APPROX_SIMPLE)
  out = []
  for contour in contours:
    m = cv2.moments(contour)
    if m['m00'] != 0:
      out.append((int(m['m10'] / m['m00']), int(m['m01'] / m['m00'])))
    else:
      out.append((0, 0))
  return sorted(out)


def _ours(binary):
  return sorted(morphology.contour_centroids(binary))


@pytest.mark.parametrize('src,dst', [(128, 128), (1000, 128), (100, 256),
                                     (1008, 128), (130, 128)])
def test_resize_nearest_equals_cv2(src, dst):
  image = np.random.default_rng(src + dst).uniform(
      size=(src, src)).astype(np.float32)
  want = cv2.resize(image, (dst, dst), interpolation=cv2.INTER_NEAREST)
  np.testing.assert_array_equal(morphology.resize_nearest(image, dst, dst),
                                want)


def test_resize_nearest_non_square_with_channels():
  image = np.random.default_rng(1).uniform(size=(50, 70, 3)).astype(
      np.float32)
  want = cv2.resize(image, (33, 41), interpolation=cv2.INTER_NEAREST)
  np.testing.assert_array_equal(morphology.resize_nearest(image, 41, 33),
                                want)


@pytest.mark.parametrize('iterations', [1, 2, 3, 4])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_erode_dilate_equal_cv2(iterations, dtype):
  rng = np.random.default_rng(iterations)
  if dtype == np.uint8:
    image = ((rng.uniform(size=(37, 53)) < 0.6) * 255).astype(np.uint8)
  else:
    image = rng.uniform(size=(37, 53)).astype(np.float32)
  np.testing.assert_array_equal(
      morphology.erode(image, iterations),
      cv2.erode(image, KERNEL, iterations=iterations))
  np.testing.assert_array_equal(
      morphology.dilate(image, iterations),
      cv2.dilate(image, KERNEL, iterations=iterations))


@pytest.mark.parametrize('seed', range(4))
def test_distance_transform_and_thresholds_equal_cv2(seed):
  rng = np.random.default_rng(seed)
  mask = (rng.uniform(size=(64, 48)) < 0.85).astype(np.uint8)
  want = cv2.distanceTransform(mask, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
  got = morphology.distance_transform_l2(mask)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  scaled = (want / want.max() * 255).astype(np.uint8)
  for thresh in (25, 140):
    _, cv_bin = cv2.threshold(scaled, thresh, 255, cv2.THRESH_BINARY)
    np.testing.assert_array_equal(
        morphology.threshold_binary(scaled, thresh, 255), cv_bin)
  probs = rng.uniform(size=(40, 40)).astype(np.float32)
  _, cv_bin = cv2.threshold(probs, 0.025, 1.0, cv2.THRESH_BINARY)
  np.testing.assert_array_equal(
      morphology.threshold_binary(probs, 0.025, 1.0), cv_bin)


def test_distance_transform_without_zero_pixels_equals_cv2():
  mask = np.ones((6, 5), np.uint8)
  np.testing.assert_array_equal(
      morphology.distance_transform_l2(mask),
      cv2.distanceTransform(mask, cv2.DIST_L2, cv2.DIST_MASK_PRECISE))


@pytest.mark.parametrize('seed', range(6))
def test_contour_centroids_of_random_blobs_equal_cv2(seed):
  rng = np.random.default_rng(seed)
  for _ in range(25):
    h, w = rng.integers(3, 48, 2)
    image = ((rng.uniform(size=(h, w)) < rng.uniform(0.2, 0.8)) * 255
             ).astype(np.uint8)
    assert _ours(image) == _cv2_centroids(image)


def test_contour_centroids_of_smoothed_blobs_equal_cv2():
  rng = np.random.default_rng(7)
  for _ in range(10):
    field = cv2.GaussianBlur(rng.uniform(size=(128, 128)).astype(np.float32),
                             (0, 0), 3.0)
    image = ((field > np.quantile(field, 0.6)) * 255).astype(np.uint8)
    assert _ours(image) == _cv2_centroids(image)


def test_rings_give_outer_and_hole_contours():
  image = np.zeros((12, 14), np.uint8)
  image[2:9, 2:10] = 255
  image[4:7, 4:8] = 0
  image[10, 0:3] = 255
  ours = _ours(image)
  assert ours == _cv2_centroids(image)
  assert len(ours) == 3  # the ring's outer border, its hole's, the line


def test_degenerate_and_border_blobs_equal_cv2():
  image = np.zeros((10, 12), np.uint8)
  image[0, 0] = 1  # one pixel, in the corner
  image[5, 2:9] = 1  # one line
  image[:, 11] = 1  # a column along the right border
  image[8:, 0:3] = 1  # a block on the bottom border
  image[3, 5] = 1  # a lone pixel
  ours = _ours(image)
  assert ours == _cv2_centroids(image)
  assert ours.count((0, 0)) == 4  # zero-area contours
  full = np.full((6, 6), 255, np.uint8)
  assert _ours(full) == _cv2_centroids(full) == [(2, 2)]
  assert _ours(np.zeros((5, 5), np.uint8)) == []
