"""The port's plots (plotting_utils.py, utils/raster.py) against the JAX
package's matplotlib figures, on the CPU.

The contract is the content of each JAX plot: where the atoms and goals
land in pixel space (within 3 px of matplotlib's `ax.transData`), the exact
inputs handed to the plotted functions (bit-equal), and the plotted rates
(the port's rate law within 1e-6 of JAX's). The test side uses matplotlib
through `pytest.importorskip`; the port never imports it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import plotting_utils as t_plot
from putting_dune_torch import rates as t_rates
from putting_dune_torch.io import png
from putting_dune_torch.utils import raster
from putting_dune_tpu import constants
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import plotting_utils as j_plot
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu.env import env as j_env_lib

plt = pytest.importorskip('matplotlib.pyplot')

RED = raster.to_rgb('tab:red')
GOLD = raster.to_rgb('gold')
PIXEL_TOL = 3.0


def _centroid(img, rgb):
  rows, cols = np.nonzero(np.all(img == np.asarray(rgb, np.uint8), -1))
  assert rows.size > 0, f'no {rgb} pixels'
  return np.array([cols.mean() + 0.5, rows.mean() + 0.5])


def _mpl_point(ax, point, height):
  x, y = ax.transData.transform(np.asarray(point, np.float64))
  return np.array([x, height - y])


def _jax_state(num_cols, seed):
  env = j_env_lib.PuttingDuneEnv(lattice=j_lattice.make_lattice(num_cols),
                                 batch_size=2)
  state, _ = env.reset(jax.random.PRNGKey(seed))
  return env, state


def _port_state(state):
  """The fields render_env_frame reads, as tensors."""
  t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
  material = state.sim.material
  return types.SimpleNamespace(
      sim=types.SimpleNamespace(
          material=types.SimpleNamespace(offset=t(material.offset),
                                         theta=t(material.theta),
                                         si_index=t(material.si_index)),
          fov=types.SimpleNamespace(lower_left=t(state.sim.fov.lower_left),
                                    upper_right=t(state.sim.fov.upper_right))),
      goal=types.SimpleNamespace(
          position_material=t(state.goal.position_material)))


@pytest.mark.parametrize('seed', [0, 3, 11])
def test_render_env_frame_lands_where_matplotlib_does(monkeypatch, seed):
  env, state = _jax_state(50, seed)
  figures = []
  monkeypatch.setattr(plt, 'close', figures.append)
  j_plot.render_env_frame(env, state)
  ax = figures[0].axes[0]
  frame = t_plot.render_env_frame(
      types.SimpleNamespace(lattice=t_lattice.make_lattice(50)),
      _port_state(state))
  assert frame.shape == (500, 500, 3) and frame.dtype == np.uint8
  material = state.sim.material
  world = np.asarray(j_lattice.world_positions(
      env.lattice, material.offset, material.theta))[0]
  si = world[int(np.asarray(material.si_index)[0])]
  goal = np.asarray(state.goal.position_material)[0]
  for point, rgb in ((si, RED), (goal, GOLD)):
    want = _mpl_point(ax, point, 500)
    assert np.abs(_centroid(frame, rgb) - want).max() <= PIXEL_TOL


@pytest.mark.parametrize('dopants', [1, 3])
def test_video_frames_land_where_matplotlib_does(dopants):
  rng = np.random.default_rng(dopants)
  lattice = np.asarray(j_lattice.make_lattice(20).positions)
  positions, numbers = [], []
  sites = rng.choice(len(lattice), size=(3, dopants), replace=False)
  for t in range(3):
    positions.append(lattice + rng.normal(size=2) * 0.3)
    z = np.full(len(lattice), constants.CARBON)
    z[sites[t]] = constants.SILICON
    numbers.append(z)
  goals = rng.uniform(-5, 5, (dopants, 2))
  anim = j_plot.generate_video_from_trajectory(positions, numbers,
                                               goal_position=goals)
  video = t_plot.generate_video_from_trajectory(positions, numbers,
                                                goal_position=goals)
  frames = video.frames
  assert len(frames) == 3
  for t in range(3):
    anim._func(t)
    anim._fig.canvas.draw()
    ax = anim._fig.axes[0]
    for site in sites[t]:
      want = _mpl_point(ax, positions[t][site], 500)
      reds = np.argwhere(np.all(frames[t] == RED, -1))[:, ::-1] + 0.5
      near = reds[np.linalg.norm(reds - want, axis=1) < 8]
      assert len(near) > 20
      assert np.abs(near.mean(0) - want).max() <= PIXEL_TOL
    for goal in goals:
      want = _mpl_point(ax, goal, 500)
      golds = np.argwhere(np.all(frames[t] == GOLD, -1))[:, ::-1] + 0.5
      near = golds[np.linalg.norm(golds - want, axis=1) < 10]
      assert np.abs(near.mean(0) - want).max() <= PIXEL_TOL
  plt.close(anim._fig)


def test_microscope_and_material_frames_keep_the_axes_contract():
  positions = np.random.default_rng(0).uniform(0, 1, (30, 2))
  numbers = np.full(30, constants.CARBON)
  numbers[3] = constants.SILICON
  fig, (ax1, ax2) = plt.subplots(1, 2)
  t_fig = raster.Figure((6.4, 4.8))
  t_ax1, t_ax2 = t_fig.subplots(1, 2)

  class Fov:
    lower_left = np.asarray([0.0, 0.0])
    width = 20.0
    height = 20.0

  for plot, axes in ((j_plot, (ax1, ax2)), (t_plot, (t_ax1, t_ax2))):
    plot.plot_microscope_frame(axes[0], positions, numbers,
                               goal_position=np.asarray([0.5, 0.5]),
                               beam_position=np.asarray([0.4, 0.6]))
    plot.plot_material_frame(axes[1], positions * 20.0, numbers, fov=Fov(),
                             goal_position=np.asarray([10.0, 10.0]))
  fig.canvas.draw()
  height = t_fig.height
  for j_ax, t_ax in ((ax1, t_ax1), (ax2, t_ax2)):
    np.testing.assert_allclose(t_ax.limits(), (j_ax.get_xlim(),
                                               j_ax.get_ylim()), atol=1e-9)
    for point in ([0.5, 0.5], positions[3] * (20.0 if t_ax is t_ax2 else 1)):
      got = np.array(t_ax.to_image(*point)).ravel()
      np.testing.assert_allclose(got, _mpl_point(j_ax, point, height),
                                 atol=0.5)
  plt.close(fig)
  img = t_fig.rgb()
  assert img.shape == (480, 640, 3) and img.std() > 0


def test_markers_have_matplotlib_sizes():
  fig = raster.Figure((2.0, 2.0))
  (ax,) = fig.subplots()
  ax.set_xlim(0, 1)
  ax.set_ylim(0, 1)
  ax.scatter([0.5], [0.5], s=400.0, c='tab:red')
  img = fig.rgb()
  area = np.all(img == RED, -1).sum()
  radius = (np.sqrt(400.0) / 2 + 0.5) * fig.dpi / 72.0
  assert abs(area / (np.pi * radius**2) - 1.0) < 0.05


def test_palette_and_viridis():
  palette = raster.Palette()
  for i in range(255):
    palette.index((i, 0, 0) if i else 'k')
  with pytest.raises(ValueError, match='256'):
    palette.index((1, 2, 3))
  cmap = pytest.importorskip('matplotlib').colormaps['viridis']
  t = np.linspace(0, 1, 101)
  want = np.round(cmap(t)[:, :3] * 255)
  assert np.abs(raster.viridis(t).astype(float) - want).max() <= 3


def _capture(fn):
  seen = []

  def wrapped(*args):
    seen.append([np.array(a) for a in args])
    return fn(*args)

  return wrapped, seen


@pytest.mark.parametrize('fixed', [None, np.array([0.1, 60.0], np.float32)])
def test_visualize_rates_feeds_the_jax_inputs(tmp_path, fixed):
  law = lambda pts: np.stack(  # noqa: E731
      [np.exp(-np.sum((np.asarray(pts)[:, -2:] - c) ** 2, -1))
       for c in ((1, 0), (0, 1), (-1, -1))], axis=-1)
  j_fn, j_seen = _capture(law)
  t_fn, t_seen = _capture(law)
  j_plot.visualize_rates(str(tmp_path / 'j.png'), j_fn, grid_range=10.0,
                         num_points=300**2, fixed_context=fixed)
  path = str(tmp_path / 't.png')
  assert t_plot.visualize_rates(path, t_fn, grid_range=10.0,
                                num_points=300**2, fixed_context=fixed) is None
  (j_in,), (t_in,) = j_seen[0], t_seen[0]
  assert j_in.dtype == t_in.dtype and j_in.shape == t_in.shape
  assert np.array_equal(j_in, t_in)
  with open(path, 'rb') as f:
    img = png.imdecode(f.read())
  assert img.shape == (500, 2000, 3) and img.std() > 0


PLOTS = [('plot_rate_function3', 'rate_function3_inputs'),
         ('plot_rate_along_neighbor_vector3', 'rate_along_neighbor_inputs'),
         ('plot_rate_along_arc3', 'rate_along_arc_inputs')]


@pytest.mark.parametrize('name,inputs', PLOTS)
@pytest.mark.parametrize('law', ['simple_canonical_rates', 'prior_rates'])
def test_rate_plots_feed_and_plot_what_jax_does(tmp_path, name, inputs, law):
  j_fn, j_seen = _capture(getattr(j_rates, law))
  t_fn, t_seen = _capture(getattr(t_rates, law))
  getattr(j_plot, name)(j_fn, save_path=str(tmp_path / 'j.png'))
  path = str(tmp_path / 't.png')
  assert getattr(t_plot, name)(t_fn, save_path=path) is None
  for j_arg, t_arg in zip(j_seen[0], t_seen[0]):
    assert j_arg.shape == t_arg.shape
    np.testing.assert_array_equal(j_arg.astype(np.float32),
                                  t_arg.astype(np.float32))
  j_rates_out = np.asarray(getattr(j_rates, law)(
      *[jnp.asarray(a) for a in j_seen[0]]))
  t_rates_out = getattr(t_rates, law)(
      *[torch.from_numpy(a) for a in t_seen[0]]).numpy()
  assert np.abs(j_rates_out - t_rates_out).max() <= 1e-6
  with open(path, 'rb') as f:
    assert png.imdecode(f.read()).std() > 0
  # The module's inputs helper is what the plot feeds.
  beams = getattr(t_plot, inputs)()[-1]
  np.testing.assert_array_equal(beams.astype(np.float32), t_seen[0][2])


def test_arc_rates_peak_at_neighbor_angles():
  """The quantity plot_rate_along_arc3 draws: on the 0.85-bond circle the
  port's simple-rates law peaks (per neighbour) at that neighbour's angle,
  as JAX's test_plotting holds the JAX law to."""
  thetas, neighbors, beams = t_plot.rate_along_arc_inputs()
  rates = t_plot._rates(t_rates.simple_canonical_rates, neighbors, beams)
  for k, ang in enumerate(np.deg2rad([0.0, 120.0, 240.0])):
    peak = thetas[np.argmax(rates[:, k])]
    assert abs(np.angle(np.exp(1j * (peak - ang)))) < np.deg2rad(5)


def test_plots_return_rgb_without_save_path():
  img = t_plot.plot_rate_along_arc3(t_rates.simple_canonical_rates)
  assert img.shape == (500, 700, 3) and img.dtype == np.uint8
  img = t_plot.visualize_rates(None, lambda x: np.ones((len(x), 3)),
                               num_points=400)
  assert img.shape == (500, 2000, 3)


def test_plot_metrics_writes_a_png_per_metric(tmp_path):
  rng = np.random.default_rng(0)
  metrics = {'train_loss': np.exp(-np.linspace(0, 3, 20))[None] * (
      1 + rng.uniform(size=(5, 1))), 'test_loss': rng.uniform(1, 2, (5, 20))}
  paths = t_plot.plot_metrics(metrics, str(tmp_path))
  assert sorted(p.rsplit('/', 1)[1] for p in paths) == [
      'test_loss.png', 'train_loss.png']
  for path in paths:
    with open(path, 'rb') as f:
      img = png.imdecode(f.read())
    assert img.shape == (480, 640, 3) and img.std() > 0
