"""A small palette raster canvas: what the port draws its plots on.

The card's machine has no matplotlib, so the port's plots (plotting_utils,
the rate learner's metric plots, the episode videos) are drawn here. The
contract is the content of the JAX package's matplotlib figures, not their
look: the numbers plotted and where they land in pixel space.

  * A `Figure` is `figsize` inches at `dpi` (5 x 5 at 100 -> 500 x 500 px);
    `subplots` lays axes out with matplotlib's default subplot parameters
    (left 0.125, right 0.9, bottom 0.11, top 0.88, wspace = hspace = 0.2).
  * An `Axes` keeps matplotlib's data -> pixel rule: limits given, or
    autoscaled to the bounding box of the data plus a 5% margin on each
    side (filled contours add no margin); `set_aspect('equal')` shrinks the
    box about its centre and keeps the limits; `set_yscale('log')` maps y
    through log10.
  * Markers are matplotlib's sizes: a scatter's `s` is the marker's area in
    points^2, so a disc has radius sqrt(s)/2 * dpi/72 px; the star and the
    cross span sqrt(s) points.
  * No antialiasing: every pixel holds one of at most 256 palette colours
    (`Palette`), which is what lets a GIF hold the frames losslessly.

Pixel (r, c) covers [c, c+1) x [r, r+1) in image coordinates (origin top
left); a display point (x, y) with y up from the bottom, as matplotlib's
`transData` gives it, lies at image coordinates (x, H - y).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

DPI = 100
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2,
               hspace=0.2)
MARGIN = 0.05
CYCLE = ('#1f77b4', '#ff7f0e', '#2ca02c', '#d62728', '#9467bd', '#8c564b',
         '#e377c2', '#7f7f7f', '#bcbd22', '#17becf')
NAMED = {
    'tab:blue': '#1f77b4', 'tab:orange': '#ff7f0e', 'tab:green': '#2ca02c',
    'tab:red': '#d62728', 'tab:purple': '#9467bd', 'tab:brown': '#8c564b',
    'tab:pink': '#e377c2', 'tab:gray': '#7f7f7f', 'tab:grey': '#7f7f7f',
    'tab:olive': '#bcbd22', 'tab:cyan': '#17becf', 'gold': '#ffd700',
    'k': '#000000', 'black': '#000000', 'w': '#ffffff', 'white': '#ffffff',
    'gray': '#808080', 'grey': '#808080', 'r': '#ff0000', 'lightgray':
    '#d3d3d3',
}
for _i, _c in enumerate(CYCLE):
  NAMED[f'C{_i}'] = _c
# matplotlib's viridis at 33 evenly spaced points, linearly interpolated.
VIRIDIS = np.array([
    (68, 1, 84), (71, 13, 96), (72, 24, 106), (72, 35, 116), (71, 45, 123),
    (69, 55, 129), (66, 64, 134), (62, 73, 137), (59, 82, 139), (55, 91, 141),
    (51, 99, 141), (47, 107, 142), (44, 114, 142), (41, 122, 142),
    (38, 130, 142), (35, 137, 142), (33, 145, 140), (31, 152, 139),
    (31, 160, 136), (34, 167, 133), (40, 174, 128), (50, 182, 122),
    (63, 188, 115), (78, 195, 107), (94, 201, 98), (112, 207, 87),
    (132, 212, 75), (152, 216, 62), (173, 220, 48), (194, 223, 35),
    (216, 226, 25), (236, 229, 27), (253, 231, 37)],
    np.float64)


def to_rgb(color) -> tuple[int, int, int]:
  """A colour name, '#rrggbb', or an RGB triple (floats in [0, 1] or ints)
  as 8-bit RGB."""
  if isinstance(color, str):
    hexa = NAMED.get(color, color)
    if not (hexa.startswith('#') and len(hexa) == 7):
      raise ValueError(f'Unknown colour {color!r}')
    return tuple(int(hexa[i:i + 2], 16) for i in (1, 3, 5))
  values = tuple(color)[:3]
  if all(isinstance(v, (int, np.integer)) for v in values):
    return tuple(int(v) for v in values)
  return tuple(int(round(255 * float(v))) for v in values)


def viridis(t) -> np.ndarray:
  """(..., 3) uint8 viridis colours of t in [0, 1]."""
  t = np.clip(np.asarray(t, np.float64), 0.0, 1.0) * (len(VIRIDIS) - 1)
  lo = np.minimum(np.floor(t).astype(np.int64), len(VIRIDIS) - 2)
  frac = (t - lo)[..., None]
  rgb = VIRIDIS[lo] * (1 - frac) + VIRIDIS[lo + 1] * frac
  return np.round(rgb).astype(np.uint8)


class Palette:
  """Up to 256 colours, each given an index the first time it is used.
  Frames that share one palette share one GIF colour table."""

  def __init__(self):
    self._colors: list[tuple[int, int, int]] = []
    self._index: dict[tuple[int, int, int], int] = {}
    self.index('w')

  def index(self, color) -> int:
    rgb = to_rgb(color)
    found = self._index.get(rgb)
    if found is None:
      if len(self._colors) == 256:
        raise ValueError('A palette holds at most 256 colours')
      found = self._index[rgb] = len(self._colors)
      self._colors.append(rgb)
    return found

  def __len__(self) -> int:
    return len(self._colors)

  def array(self) -> np.ndarray:
    """(len, 3) uint8 RGB."""
    return np.asarray(self._colors, np.uint8).reshape(-1, 3)


def nice_ticks(vmin: float, vmax: float, nbins: int) -> np.ndarray:
  """matplotlib's MaxNLocator(nbins) steps (1, 2, 2.5, 5, 10 x 10^k): the
  least step that covers [vmin, vmax] in at most `nbins` intervals."""
  if not vmax > vmin:
    vmax = vmin + 1.0
  raw = (vmax - vmin) / nbins
  scale = 10.0 ** math.floor(math.log10(raw))
  for mult in (1.0, 2.0, 2.5, 5.0, 10.0):
    step = mult * scale
    lo = math.floor(vmin / step + 1e-9) * step
    hi = math.ceil(vmax / step - 1e-9) * step
    if (hi - lo) / step <= nbins + 1e-9:
      count = int(round((hi - lo) / step))
      return lo + step * np.arange(count + 1)
  return np.array([vmin, vmax])


# --- the bitmap font ---------------------------------------------------------

_GLYPHS = {
    ' ': '..... ..... ..... ..... ..... ..... .....',
    'A': '.###. #...# #...# ##### #...# #...# #...#',
    'B': '####. #...# #...# ####. #...# #...# ####.',
    'C': '.###. #...# #.... #.... #.... #...# .###.',
    'D': '###.. #..#. #...# #...# #...# #..#. ###..',
    'E': '##### #.... #.... ####. #.... #.... #####',
    'F': '##### #.... #.... ####. #.... #.... #....',
    'G': '.###. #...# #.... #.### #...# #...# .####',
    'H': '#...# #...# #...# ##### #...# #...# #...#',
    'I': '.###. ..#.. ..#.. ..#.. ..#.. ..#.. .###.',
    'J': '..### ...#. ...#. ...#. ...#. #..#. .##..',
    'K': '#...# #..#. #.#.. ##... #.#.. #..#. #...#',
    'L': '#.... #.... #.... #.... #.... #.... #####',
    'M': '#...# ##.## #.#.# #.#.# #...# #...# #...#',
    'N': '#...# #...# ##..# #.#.# #..## #...# #...#',
    'O': '.###. #...# #...# #...# #...# #...# .###.',
    'P': '####. #...# #...# ####. #.... #.... #....',
    'Q': '.###. #...# #...# #...# #.#.# #..#. .##.#',
    'R': '####. #...# #...# ####. #.#.. #..#. #...#',
    'S': '.#### #.... #.... .###. ....# ....# ####.',
    'T': '##### ..#.. ..#.. ..#.. ..#.. ..#.. ..#..',
    'U': '#...# #...# #...# #...# #...# #...# .###.',
    'V': '#...# #...# #...# #...# #...# .#.#. ..#..',
    'W': '#...# #...# #...# #.#.# #.#.# #.#.# .#.#.',
    'X': '#...# #...# .#.#. ..#.. .#.#. #...# #...#',
    'Y': '#...# #...# .#.#. ..#.. ..#.. ..#.. ..#..',
    'Z': '##### ....# ...#. ..#.. .#... #.... #####',
    'a': '..... ..... .###. ....# .#### #...# .####',
    'b': '#.... #.... #.##. ##..# #...# #...# ####.',
    'c': '..... ..... .###. #.... #.... #...# .###.',
    'd': '....# ....# .##.# #..## #...# #...# .####',
    'e': '..... ..... .###. #...# ##### #.... .###.',
    'f': '..##. .#..# .#... ###.. .#... .#... .#...',
    'g': '..... .#### #...# #...# .#### ....# .###.',
    'h': '#.... #.... #.##. ##..# #...# #...# #...#',
    'i': '..#.. ..... .##.. ..#.. ..#.. ..#.. .###.',
    'j': '...#. ..... ..##. ...#. ...#. #..#. .##..',
    'k': '#.... #.... #..#. #.#.. ##... #.#.. #..#.',
    'l': '.##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.',
    'm': '..... ..... ##.#. #.#.# #.#.# #...# #...#',
    'n': '..... ..... #.##. ##..# #...# #...# #...#',
    'o': '..... ..... .###. #...# #...# #...# .###.',
    'p': '..... ..... ####. #...# ####. #.... #....',
    'q': '..... ..... .##.# #..## .#### ....# ....#',
    'r': '..... ..... #.##. ##..# #.... #.... #....',
    's': '..... ..... .###. #.... .###. ....# ####.',
    't': '.#... .#... ###.. .#... .#... .#..# ..##.',
    'u': '..... ..... #...# #...# #...# #..## .##.#',
    'v': '..... ..... #...# #...# #...# .#.#. ..#..',
    'w': '..... ..... #...# #...# #.#.# #.#.# .#.#.',
    'x': '..... ..... #...# .#.#. ..#.. .#.#. #...#',
    'y': '..... ..... #...# #...# .#### ....# .###.',
    'z': '..... ..... ##### ...#. ..#.. .#... #####',
    '0': '.###. #...# #..## #.#.# ##..# #...# .###.',
    '1': '..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.',
    '2': '.###. #...# ....# ...#. ..#.. .#... #####',
    '3': '##### ...#. ..#.. ...#. ....# #...# .###.',
    '4': '...#. ..##. .#.#. #..#. ##### ...#. ...#.',
    '5': '##### #.... ####. ....# ....# #...# .###.',
    '6': '..##. .#... #.... ####. #...# #...# .###.',
    '7': '##### ....# ...#. ..#.. .#... .#... .#...',
    '8': '.###. #...# #...# .###. #...# #...# .###.',
    '9': '.###. #...# #...# .#### ....# ...#. .##..',
    '.': '..... ..... ..... ..... ..... .##.. .##..',
    ',': '..... ..... ..... ..... .##.. ..#.. .#...',
    '-': '..... ..... ..... ##### ..... ..... .....',
    '_': '..... ..... ..... ..... ..... ..... #####',
    ':': '..... .##.. .##.. ..... .##.. .##.. .....',
    '=': '..... ..... ##### ..... ##### ..... .....',
    '+': '..... ..#.. ..#.. ##### ..#.. ..#.. .....',
    '(': '...#. ..#.. .#... .#... .#... ..#.. ...#.',
    ')': '.#... ..#.. ...#. ...#. ...#. ..#.. .#...',
    '[': '.###. .#... .#... .#... .#... .#... .###.',
    ']': '.###. ...#. ...#. ...#. ...#. ...#. .###.',
    '/': '..... ....# ...#. ..#.. .#... #.... .....',
    '>': '.#... ..#.. ...#. ....# ...#. ..#.. .#...',
    '<': '...#. ..#.. .#... #.... .#... ..#.. ...#.',
    "'": '..#.. ..#.. .#... ..... ..... ..... .....',
    '!': '..#.. ..#.. ..#.. ..#.. ..#.. ..... ..#..',
    '?': '.###. #...# ....# ...#. ..#.. ..... ..#..',
    '%': '##... ##..# ...#. ..#.. .#... #..## ...##',
    '*': '..... ..#.. #.#.# .###. #.#.# ..#.. .....',
    '^': '..#.. .#.#. #...# ..... ..... ..... .....',
}
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6
_FONT = {ch: np.array([[c == '#' for c in row] for row in rows.split()])
         for ch, rows in _GLYPHS.items()}


def text_size(text: str, scale: int = 1) -> tuple[int, int]:
  """(width, height) in pixels of `text` at `scale`."""
  return max(len(text) * ADVANCE - 1, 0) * scale, GLYPH_H * scale


def draw_text(img: np.ndarray, x: float, y: float, text: str, index: int,
              scale: int = 1, ha: str = 'left', va: str = 'top') -> None:
  """Writes `text` into the index image with its anchor at image
  coordinates (x, y); ha in left/center/right, va in top/center/bottom."""
  w, h = text_size(text, scale)
  x0 = int(round(x - {'left': 0, 'center': w / 2, 'right': w}[ha]))
  y0 = int(round(y - {'top': 0, 'center': h / 2, 'bottom': h}[va]))
  for k, ch in enumerate(text.replace('−', '-')):
    glyph = _FONT.get(ch, _FONT['?'])
    if scale > 1:
      glyph = np.kron(glyph, np.ones((scale, scale), bool))
    gx = x0 + k * ADVANCE * scale
    _blit(img, gx, y0, glyph, index)


def _blit(img, x0, y0, mask, index) -> None:
  h, w = img.shape
  ys, xs = np.nonzero(mask)
  ys, xs = ys + y0, xs + x0
  keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
  img[ys[keep], xs[keep]] = index


# --- primitives on an index image, clipped to a box --------------------------


class Clip:
  """An integer pixel rectangle [r0, r1) x [c0, c1)."""

  def __init__(self, r0, r1, c0, c1):
    self.r0, self.r1, self.c0, self.c1 = int(r0), int(r1), int(c0), int(c1)

  def keep(self, rows, cols):
    return ((rows >= self.r0) & (rows < self.r1) & (cols >= self.c0)
            & (cols < self.c1))


def _stamp(img, cx, cy, radius, index, clip: Clip) -> None:
  """Fills every pixel whose centre lies within `radius` of a centre
  (cx, cy), for arrays of centres at once."""
  cx = np.asarray(cx, np.float64).reshape(-1)
  cy = np.asarray(cy, np.float64).reshape(-1)
  if cx.size == 0:
    return
  reach = int(math.ceil(radius)) + 1
  offs = np.arange(-reach, reach + 1)
  dy, dx = np.meshgrid(offs, offs, indexing='ij')
  rows = np.floor(cy)[:, None].astype(np.int64) + dy.reshape(1, -1)
  cols = np.floor(cx)[:, None].astype(np.int64) + dx.reshape(1, -1)
  inside = ((cols + 0.5 - cx[:, None]) ** 2
            + (rows + 0.5 - cy[:, None]) ** 2) <= radius * radius
  inside &= clip.keep(rows, cols)
  img[rows[inside], cols[inside]] = index


def _fill_polygon(img, verts, index, clip: Clip) -> None:
  """Even-odd fill of one polygon (V, 2) in image coordinates, on pixel
  centres."""
  verts = np.asarray(verts, np.float64)
  c0 = max(int(math.floor(verts[:, 0].min())), clip.c0)
  c1 = min(int(math.ceil(verts[:, 0].max())) + 1, clip.c1)
  r0 = max(int(math.floor(verts[:, 1].min())), clip.r0)
  r1 = min(int(math.ceil(verts[:, 1].max())) + 1, clip.r1)
  if c0 >= c1 or r0 >= r1:
    return
  py, px = np.meshgrid(np.arange(r0, r1) + 0.5, np.arange(c0, c1) + 0.5,
                       indexing='ij')
  inside = np.zeros(px.shape, bool)
  x1, y1 = verts[:, 0], verts[:, 1]
  x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
  for a, b, c, d in zip(x1, y1, x2, y2):
    if b == d:
      continue
    crosses = (py >= min(b, d)) & (py < max(b, d))
    xs = a + (py - b) * (c - a) / (d - b)
    inside ^= crosses & (px < xs)
  img[r0:r1, c0:c1][inside] = index


def _stroke(img, points, width_px, index, clip: Clip,
            dash: Optional[tuple[float, float]] = None) -> None:
  """A polyline (P, 2) in image coordinates, `width_px` wide, optionally
  dashed (on, off) in pixels along its length."""
  pts = np.asarray(points, np.float64)
  pts = pts[np.all(np.isfinite(pts), axis=1)]
  if len(pts) == 0:
    return
  if len(pts) == 1:
    samples = pts
  else:
    seg = np.diff(pts, axis=0)
    length = np.hypot(seg[:, 0], seg[:, 1])
    count = np.maximum(np.ceil(length / 0.5).astype(np.int64), 1)
    starts = np.repeat(pts[:-1], count, axis=0)
    steps = np.repeat(seg / count[:, None], count, axis=0)
    k = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    samples = np.concatenate([starts + steps * k[:, None], pts[-1:]])
    if dash is not None:
      along = np.concatenate([[0.0], np.cumsum(np.hypot(
          *np.diff(samples, axis=0).T))])
      samples = samples[np.mod(along, dash[0] + dash[1]) < dash[0]]
  # At least 0.55 px, so that a hairline on a pixel boundary still covers
  # one row of pixel centres whatever its rounding.
  _stamp(img, samples[:, 0], samples[:, 1], max(width_px / 2, 0.55), index,
         clip)


# --- figures and axes ----------------------------------------------------------


def _points_px(points: float, dpi: float) -> float:
  return points * dpi / 72.0


class Axes:
  """One plot area of a Figure; see the module docstring for its rules.
  Artists are kept and drawn in z-order when the figure renders, after the
  limits are resolved."""

  def __init__(self, figure: 'Figure', frac_box):
    self.figure = figure
    self.frac_box = frac_box  # (left, bottom, right, top) figure fractions
    self._artists = []
    self._data_x: list[np.ndarray] = []
    self._data_y: list[np.ndarray] = []
    self._tight = False
    self._cycle = 0
    self.xlim: Optional[tuple[float, float]] = None
    self.ylim: Optional[tuple[float, float]] = None
    self.aspect: Optional[str] = None
    self.yscale = 'linear'
    self.title = ''
    self.xlabel = ''
    self.ylabel = ''
    self.show_legend = False

  # -- artists --------------------------------------------------------------

  def _add(self, zorder, kind, **data):
    self._artists.append((zorder, len(self._artists), kind, data))

  def _note(self, x, y):
    self._data_x.append(np.asarray(x, np.float64).reshape(-1))
    self._data_y.append(np.asarray(y, np.float64).reshape(-1))

  def _next_color(self) -> str:
    color = CYCLE[self._cycle % len(CYCLE)]
    self._cycle += 1
    return color

  def scatter(self, x, y, s=36.0, c=None, marker='o', edgecolors=None,
              label=None, zorder=1.0) -> None:
    """matplotlib's scatter of one colour: `s` in points^2; markers 'o'
    (disc), '*' (five-pointed star) and 'x'."""
    if marker not in ('o', '*', 'x'):
      raise ValueError(f'Unsupported marker {marker!r}')
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    color = c if c is not None else self._next_color()
    self._note(x, y)
    self._add(zorder, 'scatter', x=x, y=y, s=float(s), color=color,
              marker=marker, edge=edgecolors, label=label)

  def plot(self, x, y=None, color=None, linewidth=1.5, label=None) -> None:
    """A polyline (y against its index when y is omitted), in the next
    cycle colour unless `color` is given."""
    if y is None:
      y = np.asarray(x, np.float64)
      x = np.arange(len(y), dtype=np.float64)
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    color = color if color is not None else self._next_color()
    self._note(x, y)
    self._add(2.0, 'line', x=x, y=y, color=color, width=linewidth,
              dashed=False, label=label)

  def axvline(self, x, color='C0', linestyle='-', linewidth=1.5,
              label=None) -> None:
    self._data_x.append(np.asarray([x], np.float64))
    self._add(2.0, 'vline', x=float(x), color=color, width=linewidth,
              dashed=linestyle == '--', label=label)

  def rectangle(self, xy, width, height, edgecolor='k',
                linestyle='--') -> None:
    """An unfilled rectangle (matplotlib's add_patch of a Rectangle with
    fill=False); patches take part in the autoscale."""
    x0, y0 = float(xy[0]), float(xy[1])
    xs = np.array([x0, x0 + width, x0 + width, x0, x0])
    ys = np.array([y0, y0, y0 + height, y0 + height, y0])
    self._note(xs, ys)
    self._add(1.0, 'line', x=xs, y=ys, color=edgecolor, width=1.0,
              dashed=linestyle == '--', label=None)

  def contourf(self, xx, yy, z, levels: int = 20) -> np.ndarray:
    """Filled contours of z on the grid (xx, yy) (np.meshgrid of two
    ascending evenly spaced axes), `levels` as matplotlib's
    MaxNLocator(levels + 1); returns the level boundaries."""
    xs = np.asarray(xx, np.float64)[0]
    ys = np.asarray(yy, np.float64)[:, 0]
    z = np.asarray(z, np.float64)
    bounds = nice_ticks(float(np.nanmin(z)), float(np.nanmax(z)), levels + 1)
    self._note(xs[[0, -1]], ys[[0, -1]])
    self._tight = True
    self._add(1.0, 'contourf', xs=xs, ys=ys, z=z, bounds=bounds)
    return bounds

  # -- settings ---------------------------------------------------------------

  def set_xlim(self, lo, hi) -> None:
    self.xlim = (float(lo), float(hi))

  def set_ylim(self, lo, hi) -> None:
    self.ylim = (float(lo), float(hi))

  def set_aspect(self, aspect: str) -> None:
    self.aspect = aspect

  def set_yscale(self, scale: str) -> None:
    if scale not in ('linear', 'log'):
      raise ValueError(f'Unsupported y scale {scale!r}')
    self.yscale = scale

  def set_title(self, title: str) -> None:
    self.title = title

  def set_xlabel(self, label: str) -> None:
    self.xlabel = label

  def set_ylabel(self, label: str) -> None:
    self.ylabel = label

  def legend(self) -> None:
    self.show_legend = True

  # -- geometry ---------------------------------------------------------------

  def _ty(self, y):
    y = np.asarray(y, np.float64)
    if self.yscale == 'log':
      with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(y > 0, np.log10(np.where(y > 0, y, 1.0)), np.nan)
    return y

  def _auto(self, values, given, tight):
    if given is not None:
      return given
    values = np.concatenate(values) if values else np.zeros(0)
    values = values[np.isfinite(values)]
    if values.size == 0:
      return (0.0, 1.0)
    lo, hi = float(values.min()), float(values.max())
    if hi == lo:
      pad = abs(lo) * 0.05 or 0.05
      return (lo - pad, hi + pad)
    pad = 0.0 if tight else MARGIN * (hi - lo)
    return (lo - pad, hi + pad)

  def limits(self):
    """((x0, x1), (y0, y1)) as drawn; y in log10 units on a log axis."""
    xlim = self._auto(self._data_x, self.xlim, self._tight)
    ylim_given = None if self.ylim is None else tuple(self._ty(self.ylim))
    ylim = self._auto([self._ty(y) for y in self._data_y], ylim_given,
                      self._tight)
    return xlim, ylim

  def box(self):
    """(x0, y0, x1, y1) of the axes in display pixels (y up), after an
    equal aspect shrank it about its centre."""
    w, h = self.figure.width, self.figure.height
    left, bottom, right, top = self.frac_box
    x0, x1, y0, y1 = left * w, right * w, bottom * h, top * h
    if self.aspect == 'equal':
      (ax0, ax1), (ay0, ay1) = self.limits()
      want = abs(ay1 - ay0) / abs(ax1 - ax0)  # box height / width
      bw, bh = x1 - x0, y1 - y0
      if bw * want <= bh:
        nw, nh = bw, bw * want
      else:
        nw, nh = bh / want, bh
      cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
      x0, x1, y0, y1 = cx - nw / 2, cx + nw / 2, cy - nh / 2, cy + nh / 2
    return x0, y0, x1, y1

  def to_display(self, x, y):
    """Data -> display pixels (x right, y up from the figure's bottom), as
    matplotlib's ax.transData."""
    (ax0, ax1), (ay0, ay1) = self.limits()
    bx0, by0, bx1, by1 = self.box()
    px = bx0 + (np.asarray(x, np.float64) - ax0) / (ax1 - ax0) * (bx1 - bx0)
    py = by0 + (self._ty(y) - ay0) / (ay1 - ay0) * (by1 - by0)
    return px, py

  def to_image(self, x, y):
    """Data -> image coordinates (column, row) with the origin top left."""
    px, py = self.to_display(x, y)
    return px, self.figure.height - py

  # -- drawing ----------------------------------------------------------------

  def _clip(self) -> Clip:
    bx0, by0, bx1, by1 = self.box()
    h = self.figure.height
    return Clip(math.floor(h - by1), math.ceil(h - by0), math.floor(bx0),
                math.ceil(bx1))

  def draw(self, img: np.ndarray) -> None:
    palette, dpi = self.figure.palette, self.figure.dpi
    clip = self._clip()
    for _, _, kind, d in sorted(self._artists, key=lambda a: a[:2]):
      getattr(self, f'_draw_{kind}')(img, d, palette, dpi, clip)
    self._draw_frame(img, palette, dpi)
    if self.show_legend:
      self._draw_legend(img, palette, dpi)

  def _draw_scatter(self, img, d, palette, dpi, clip):
    cx, cy = self.to_image(d['x'], d['y'])
    size = math.sqrt(d['s'])  # points
    index = palette.index(d['color'])
    if d['marker'] == 'o':
      # The edge (1 pt, in the face colour by default) widens the disc.
      _stamp(img, cx, cy, _points_px(size / 2 + 0.5, dpi), index, clip)
      return
    half = _points_px(size / 2, dpi)
    if d['marker'] == 'x':
      for px, py in zip(cx, cy):
        for sx in (-1, 1):
          seg = np.array([[px - half, py - sx * half],
                          [px + half, py + sx * half]])
          _stroke(img, seg, _points_px(1.5, dpi), index, clip)
      return
    angles = np.pi / 2 + np.arange(10) * np.pi / 5
    radii = np.where(np.arange(10) % 2 == 0, 1.0, 0.381966) * half
    unit = np.stack([np.cos(angles) * radii, -np.sin(angles) * radii], -1)
    edge = None if d['edge'] is None else palette.index(d['edge'])
    for px, py in zip(cx, cy):
      verts = unit + np.array([px, py])
      _fill_polygon(img, verts, index, clip)
      if edge is not None:
        _stroke(img, np.concatenate([verts, verts[:1]]),
                _points_px(1.0, dpi), edge, clip)

  def _draw_line(self, img, d, palette, dpi, clip):
    cx, cy = self.to_image(d['x'], d['y'])
    dash = None
    if d['dashed']:
      dash = (_points_px(3.7 * d['width'], dpi),
              _points_px(1.6 * d['width'], dpi))
    _stroke(img, np.stack([cx, cy], -1), _points_px(d['width'], dpi),
            palette.index(d['color']), clip, dash)

  def _draw_vline(self, img, d, palette, dpi, clip):
    cx, _ = self.to_image(d['x'], 0.0)
    bx0, by0, bx1, by1 = self.box()
    h = self.figure.height
    pts = np.array([[float(cx), h - by0], [float(cx), h - by1]])
    dash = None
    if d['dashed']:
      dash = (_points_px(3.7 * d['width'], dpi),
              _points_px(1.6 * d['width'], dpi))
    _stroke(img, pts, _points_px(d['width'], dpi), palette.index(d['color']),
            clip, dash)

  def _draw_contourf(self, img, d, palette, dpi, clip):
    rows = np.arange(clip.r0, clip.r1)
    cols = np.arange(clip.c0, clip.c1)
    (ax0, ax1), (ay0, ay1) = self.limits()
    bx0, by0, bx1, by1 = self.box()
    h = self.figure.height
    x = ax0 + (cols + 0.5 - bx0) / (bx1 - bx0) * (ax1 - ax0)
    y = ay0 + (h - rows - 0.5 - by0) / (by1 - by0) * (ay1 - ay0)
    xs, ys, z = d['xs'], d['ys'], d['z']
    fx = (x - xs[0]) / (xs[-1] - xs[0]) * (len(xs) - 1)
    fy = (y - ys[0]) / (ys[-1] - ys[0]) * (len(ys) - 1)
    okx = (fx >= 0) & (fx <= len(xs) - 1)
    oky = (fy >= 0) & (fy <= len(ys) - 1)
    ix = np.clip(np.floor(fx).astype(np.int64), 0, len(xs) - 2)
    iy = np.clip(np.floor(fy).astype(np.int64), 0, len(ys) - 2)
    tx, ty = (fx - ix)[None, :], (fy - iy)[:, None]
    z00 = z[iy][:, ix]
    z01 = z[iy][:, ix + 1]
    z10 = z[iy + 1][:, ix]
    z11 = z[iy + 1][:, ix + 1]
    value = ((z00 * (1 - tx) + z01 * tx) * (1 - ty)
             + (z10 * (1 - tx) + z11 * tx) * ty)
    bounds = d['bounds']
    bands = len(bounds) - 1
    band = np.clip(np.searchsorted(bounds, value, side='right') - 1, 0,
                   bands - 1)
    colors = viridis(np.arange(bands) / max(bands - 1, 1))
    lut = np.array([palette.index(tuple(int(v) for v in c)) for c in colors],
                   np.uint8)
    sub = img[clip.r0:clip.r1, clip.c0:clip.c1]
    keep = oky[:, None] & okx[None, :] & np.isfinite(value)
    sub[keep] = lut[band[keep]]

  def _draw_frame(self, img, palette, dpi):
    """Spines, ticks with their labels, title and axis labels."""
    black = palette.index('k')
    bx0, by0, bx1, by1 = self.box()
    h = self.figure.height
    full = Clip(0, img.shape[0], 0, img.shape[1])
    top, bottom = h - by1, h - by0
    corners = np.array([[bx0, bottom], [bx1, bottom], [bx1, top],
                        [bx0, top], [bx0, bottom]])
    _stroke(img, corners, 1.0, black, full)
    (ax0, ax1), (ay0, ay1) = self.limits()
    tick = _points_px(3.5, dpi)
    for value in nice_ticks(min(ax0, ax1), max(ax0, ax1),
                            _tick_bins(bx1 - bx0)):
      if not min(ax0, ax1) - 1e-9 <= value <= max(ax0, ax1) + 1e-9:
        continue
      px = bx0 + (value - ax0) / (ax1 - ax0) * (bx1 - bx0)
      _stroke(img, np.array([[px, bottom], [px, bottom + tick]]), 1.0,
              black, full)
      draw_text(img, px, bottom + tick + 3, _tick_label(value, ax0, ax1),
                black, 1, ha='center')
    for value in nice_ticks(min(ay0, ay1), max(ay0, ay1),
                            _tick_bins(by1 - by0)):
      if not min(ay0, ay1) - 1e-9 <= value <= max(ay0, ay1) + 1e-9:
        continue
      py = h - (by0 + (value - ay0) / (ay1 - ay0) * (by1 - by0))
      _stroke(img, np.array([[bx0 - tick, py], [bx0, py]]), 1.0, black,
              full)
      label = (f'1e{int(round(value))}' if self.yscale == 'log'
               else _tick_label(value, ay0, ay1))
      draw_text(img, bx0 - tick - 3, py, label, black, 1, ha='right',
                va='center')
    if self.title:
      draw_text(img, (bx0 + bx1) / 2, top - _points_px(6.0, dpi),
                self.title, black, 2, ha='center', va='bottom')
    if self.xlabel:
      draw_text(img, (bx0 + bx1) / 2, bottom + tick + 14, self.xlabel,
                black, 1, ha='center')
    if self.ylabel:
      draw_text(img, max(bx0 - 60, 2), (top + bottom) / 2, self.ylabel,
                black, 1, ha='left', va='center')

  def _draw_legend(self, img, palette, dpi):
    entries = [(kind, d) for _, _, kind, d in sorted(
        self._artists, key=lambda a: a[:2]) if d.get('label')]
    if not entries:
      return
    bx0, by0, bx1, by1 = self.box()
    h = self.figure.height
    row_h, sample_w, scale = 18, 24, 1
    text_w = max(text_size(d['label'], scale)[0] for _, d in entries)
    width = sample_w + 12 + text_w
    height = row_h * len(entries) + 6
    right, top = int(bx1) - 8, int(h - by1) + 8
    left = right - width
    img[top:top + height, left:right] = palette.index('w')
    edge = np.array([[left, top], [right, top], [right, top + height],
                     [left, top + height], [left, top]], np.float64)
    full = Clip(0, img.shape[0], 0, img.shape[1])
    _stroke(img, edge, 1.0, palette.index('lightgray'), full)
    for i, (kind, d) in enumerate(entries):
      cy = top + 3 + row_h * i + row_h / 2
      index = palette.index(d['color'])
      if kind == 'scatter':
        _stamp(img, [left + 4 + sample_w / 2], [cy], 4.0, index, full)
      else:
        _stroke(img, np.array([[left + 4, cy], [left + 4 + sample_w, cy]]),
                _points_px(d['width'], dpi), index, full)
      draw_text(img, left + 8 + sample_w, cy, d['label'], palette.index('k'),
                scale, va='center')


def _tick_bins(length_px: float) -> int:
  return max(3, min(9, int(length_px // 45)))


def _tick_label(value: float, lo: float, hi: float) -> str:
  ticks = nice_ticks(min(lo, hi), max(lo, hi), 9)
  step = float(ticks[1] - ticks[0]) if len(ticks) > 1 else 1.0
  decimals = max(0, -int(math.floor(math.log10(step) + 1e-9)))
  if abs(step * 10**decimals - round(step * 10**decimals)) > 1e-6:
    decimals += 1
  text = f'{value:.{decimals}f}'
  return '0' if float(text) == 0 else text


class Figure:
  """A `figsize`-inch canvas at `dpi`; its axes draw onto it at `render`.
  Pass one `palette` to the frames of one video."""

  def __init__(self, figsize: Sequence[float] = (5.0, 5.0), dpi: int = DPI,
               palette: Optional[Palette] = None):
    self.dpi = dpi
    self.width = int(round(figsize[0] * dpi))
    self.height = int(round(figsize[1] * dpi))
    self.palette = palette if palette is not None else Palette()
    self.axes: list[Axes] = []

  def subplots(self, nrows: int = 1, ncols: int = 1) -> list[Axes]:
    """nrows x ncols axes (row-major) in matplotlib's default layout."""
    p = SUBPLOT
    cell_w = (p['right'] - p['left']) / (ncols + p['wspace'] * (ncols - 1))
    cell_h = (p['top'] - p['bottom']) / (nrows + p['hspace'] * (nrows - 1))
    out = []
    for i in range(nrows):
      for j in range(ncols):
        left = p['left'] + j * cell_w * (1 + p['wspace'])
        top = p['top'] - i * cell_h * (1 + p['hspace'])
        ax = Axes(self, (left, top - cell_h, left + cell_w, top))
        self.axes.append(ax)
        out.append(ax)
    return out

  def render(self) -> np.ndarray:
    """(height, width) uint8 palette indices."""
    img = np.full((self.height, self.width), self.palette.index('w'),
                  np.uint8)
    for ax in self.axes:
      ax.draw(img)
    return img

  def rgb(self) -> np.ndarray:
    """(height, width, 3) uint8."""
    indices = self.render()
    return self.palette.array()[indices]

  def savefig(self, path: str) -> None:
    """Writes the figure as a PNG."""
    from putting_dune_torch.io import png

    with open(path, 'wb') as f:
      f.write(png.imencode(self.rgb()))
