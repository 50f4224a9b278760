"""Binary-image morphology and contour centroids, in numpy and scipy.

The JAX package's aligner and detector post-process with OpenCV; these
are the same functions without it, each equal to the OpenCV call it
replaces on every input the tests give:

  * `resize_nearest`: `cv2.resize(..., interpolation=INTER_NEAREST)`, the
    source index floor(i * src / dst) (not centre-exact);
  * `resize_bilinear`: `cv2.resize(..., interpolation=INTER_LINEAR)` on
    float32 frames: half-pixel centres, edge clamp, within 1e-6;
  * `erode`, `dilate`: a 2 x 2 kernel at OpenCV's default anchor (1, 1),
    so each pass takes the min (max) over the pixel and its upper-left
    neighbours, outside pixels ignored, `iterations` passes;
  * `threshold_binary`: `cv2.threshold(..., THRESH_BINARY)`;
  * `distance_transform_l2`: `cv2.distanceTransform(DIST_L2,
    DIST_MASK_PRECISE)`, the exact Euclidean distance of each nonzero
    pixel to the nearest zero pixel of the image (2**64 everywhere when
    there is none);
  * `contour_centroids`: what `cv2.findContours(RETR_LIST,
    CHAIN_APPROX_SIMPLE)` then `cv2.moments(contour)` give. The borders are
    traced as Suzuki and Abe (1985) trace them (8-connected outer borders,
    the borders of 4-connected holes), and a contour's moments are those of
    the polygon through its boundary pixels' centres (Green's formula), not
    the blob's pixel mean. A one-pixel or one-line blob has zero area: its
    centroid is None. A ring gives two contours, its outer border and its
    hole's. CHAIN_APPROX_SIMPLE drops collinear points only, which leaves
    the polygon, so its moments, unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage


def resize_nearest(image: np.ndarray, height: int, width: int) -> np.ndarray:
  """Nearest-neighbour resize of the two leading axes to (height, width):
  output pixel i reads source floor(i * (1 / (dst / src))), clamped."""

  def index(src: int, dst: int) -> np.ndarray:
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)

  image = np.asarray(image)
  return image[index(image.shape[0], height)][:, index(image.shape[1], width)]


def _linear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
  """OpenCV's INTER_LINEAR taps along one axis: output i reads source
  x0 and x0 + 1 with weights 1 - f and f, f = (i + 0.5) * src / dst - 0.5
  less its floor, in float64; f is 0 left of the first and right of the
  last source centre (edge clamp)."""
  scale = 1.0 / (dst / src)
  pos = (np.arange(dst) + 0.5) * scale - 0.5
  x0 = np.floor(pos).astype(np.int64)
  frac = pos - x0
  frac[x0 < 0] = 0.0
  x0 = np.maximum(x0, 0)
  last = x0 >= src - 1
  frac[last] = 0.0
  x0[last] = src - 1
  return x0, np.minimum(x0 + 1, src - 1), frac


def resize_bilinear(image: np.ndarray, height: int, width: int
                    ) -> np.ndarray:
  """Bilinear resize of a float (H, W) frame to (height, width), float32:
  the horizontal pass, then the vertical one, as OpenCV computes it."""
  image = np.asarray(image, np.float32)
  c0, c1, fx = _linear_taps(image.shape[1], width)
  wx0, wx1 = (1.0 - fx).astype(np.float32), fx.astype(np.float32)
  rows = image[:, c0] * wx0 + image[:, c1] * wx1
  r0, r1, fy = _linear_taps(image.shape[0], height)
  wy0, wy1 = (1.0 - fy).astype(np.float32), fy.astype(np.float32)
  return rows[r0] * wy0[:, None] + rows[r1] * wy1[:, None]


def _min_max_filter(image: np.ndarray, iterations: int, op) -> np.ndarray:
  out = np.asarray(image).copy()
  for _ in range(iterations):
    shifted = out.copy()
    shifted[1:] = op(shifted[1:], out[:-1])
    both = shifted.copy()
    both[:, 1:] = op(both[:, 1:], shifted[:, :-1])
    out = both
  return out


def erode(image: np.ndarray, iterations: int = 1) -> np.ndarray:
  """cv2.erode with a 2 x 2 kernel of ones (anchor (1, 1))."""
  return _min_max_filter(image, iterations, np.minimum)


def dilate(image: np.ndarray, iterations: int = 1) -> np.ndarray:
  """cv2.dilate with a 2 x 2 kernel of ones (anchor (1, 1))."""
  return _min_max_filter(image, iterations, np.maximum)


def threshold_binary(image: np.ndarray, thresh, maxval) -> np.ndarray:
  """`maxval` where image > thresh, else 0, in the image's dtype."""
  image = np.asarray(image)
  return np.where(image > thresh, maxval, 0).astype(image.dtype)


def distance_transform_l2(image: np.ndarray) -> np.ndarray:
  """Exact Euclidean distance (float32) of each nonzero pixel to the
  nearest zero pixel; 0 on zero pixels."""
  image = np.asarray(image)
  if not (image == 0).any():
    # No zero pixel: OpenCV reports 2**64 everywhere.
    return np.full(image.shape, 2.0**64, np.float32)
  return ndimage.distance_transform_edt(image != 0).astype(np.float32)


# Suzuki-Abe neighbourhood, clockwise from east in (row, col) image
# coordinates (rows grow downwards): E, SE, S, SW, W, NW, N, NE.
_DIRS = ((0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1))
_DIR_INDEX = {d: k for k, d in enumerate(_DIRS)}


def _trace(f: np.ndarray, i: int, j: int, i2: int, j2: int, nbd: int
           ) -> List[Tuple[int, int]]:
  """Follows one border from (i, j), (i2, j2) its zero neighbour where the
  scan entered (steps 3.1-3.5 of Suzuki and Abe); labels `f` in place and
  returns the border's pixels (row, col) in order."""
  start = _DIR_INDEX[(i2 - i, j2 - j)]
  found = None
  for k in range(8):  # 3.1: clockwise from (i2, j2).
    d = (start + k) % 8
    if f[i + _DIRS[d][0], j + _DIRS[d][1]] != 0:
      found = d
      break
  if found is None:
    f[i, j] = -nbd
    return [(i, j)]
  i1, j1 = i + _DIRS[found][0], j + _DIRS[found][1]
  i2, j2, i3, j3 = i1, j1, i, j
  points = [(i, j)]
  while True:
    # 3.3: counterclockwise around (i3, j3), from the element after (i2, j2).
    back = _DIR_INDEX[(i2 - i3, j2 - j3)]
    east_zero_examined = False
    for k in range(1, 9):
      d = (back - k) % 8
      ni, nj = i3 + _DIRS[d][0], j3 + _DIRS[d][1]
      if f[ni, nj] != 0:
        i4, j4 = ni, nj
        break
      if d == 0:
        east_zero_examined = True
    # 3.4
    if east_zero_examined:
      f[i3, j3] = -nbd
    elif f[i3, j3] == 1:
      f[i3, j3] = nbd
    # 3.5
    if (i4, j4) == (i, j) and (i3, j3) == (i1, j1):
      return points
    i2, j2, i3, j3 = i3, j3, i4, j4
    points.append((i3, j3))


def find_contours(binary: np.ndarray) -> List[np.ndarray]:
  """Every border of a binary image (nonzero = 1), outer and hole, as
  (N, 2) int arrays of (x, y) = (col, row) points, in the order the raster
  scan finds them."""
  h, w = binary.shape
  f = np.zeros((h + 2, w + 2), np.int64)
  f[1:-1, 1:-1] = np.asarray(binary) != 0
  # Only pixels with a zero left or right neighbour can start a border.
  ones = f != 0
  candidates = ones & ~(np.roll(ones, 1, axis=1) & np.roll(ones, -1, axis=1))
  contours = []
  nbd = 1
  for i, j in zip(*np.nonzero(candidates)):
    if f[i, j] == 1 and f[i, j - 1] == 0:
      nbd += 1
      points = _trace(f, i, j, i, j - 1, nbd)
    elif f[i, j] >= 1 and f[i, j + 1] == 0:
      nbd += 1
      points = _trace(f, i, j, i, j + 1, nbd)
    else:
      continue
    contours.append(np.asarray(points, np.int64)[:, ::-1] - 1)
  return contours


def polygon_centroid(points: np.ndarray) -> Optional[Tuple[float, float]]:
  """(m10 / m00, m01 / m00) of a closed polygon of (x, y) integer points,
  as cv2.moments computes them; None where m00 is 0."""
  x = points[:, 0].astype(np.float64)
  y = points[:, 1].astype(np.float64)
  xp, yp = np.roll(x, 1), np.roll(y, 1)
  dxy = xp * y - x * yp
  a00 = float(dxy.sum())
  if abs(a00) <= np.finfo(np.float32).eps:
    return None
  a10 = float((dxy * (xp + x)).sum())
  a01 = float((dxy * (yp + y)).sum())
  sign = 1.0 if a00 > 0 else -1.0
  m00 = a00 * (0.5 * sign)
  return (a10 * (0.16666666666666666 * sign) / m00,
          a01 * (0.16666666666666666 * sign) / m00)


def contour_centroids(binary: np.ndarray) -> List[Tuple[int, int]]:
  """The integer (x, y) centroid of every contour of a binary image, as
  `int(m10 / m00), int(m01 / m00)` of cv2.moments, and (0, 0) for a
  contour of zero area (the JAX package's rule)."""
  centroids = []
  for contour in find_contours(binary):
    c = polygon_centroid(contour)
    centroids.append((0, 0) if c is None else (int(c[0]), int(c[1])))
  return centroids
