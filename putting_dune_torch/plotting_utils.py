"""Frame plots, rate-function plots and episode videos, without matplotlib.

Port of putting_dune_tpu/plotting_utils.py, drawn on the port's own canvas
(utils/raster.py) and written by its own PNG and GIF writers (io/png.py,
io/gif.py): the card's machine has no matplotlib, PIL or imageio. The
contract is each JAX plot's content: the numbers plotted, where they land
in pixel space (matplotlib's default layout, autoscale and marker sizes),
and the files written under the JAX names. Where a JAX function returns a
matplotlib Figure (save_path None), the port returns the figure as an RGB
uint8 array; `plot_atoms`, `plot_microscope_frame` and
`plot_material_frame` draw on a `raster.Axes` where JAX takes a matplotlib
`ax`. The rate functions plotted take tensors (the port's rate functions)
and their inputs are built in numpy exactly as the JAX package builds
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch.utils import raster

_ATOM_COLORS = {constants.CARBON: 'tab:gray', constants.SILICON: 'tab:red'}
FIGSIZE = (5.0, 5.0)


def plot_atoms(ax: raster.Axes, positions: np.ndarray,
               atomic_numbers: np.ndarray, scale: float = 1.0) -> None:
  """Scatter atoms coloured by species, sized by atomic number."""
  positions = np.asarray(positions)
  atomic_numbers = np.asarray(atomic_numbers)
  for z in np.unique(atomic_numbers):
    if z == 0:
      continue  # padding
    sel = atomic_numbers == z
    ax.scatter(positions[sel, 0], positions[sel, 1],
               s=30.0 * (z / constants.CARBON) * scale,
               c=_ATOM_COLORS.get(int(z), 'tab:blue'), label=f'Z={int(z)}')


def _goal_and_beam(ax, goal_position, beam_position) -> None:
  if goal_position is not None:
    goals = np.asarray(goal_position).reshape(-1, 2)  # one or D goals
    ax.scatter(goals[:, 0], goals[:, 1], marker='*', s=180, c='gold',
               edgecolors='k', label='goal', zorder=5)
  if beam_position is not None:
    beam = np.asarray(beam_position).reshape(2)
    ax.scatter(beam[:1], beam[1:], marker='x', s=100, c='tab:green',
               label='beam', zorder=5)


def plot_microscope_frame(ax: raster.Axes, positions: np.ndarray,
                          atomic_numbers: np.ndarray,
                          goal_position: Optional[np.ndarray] = None,
                          beam_position: Optional[np.ndarray] = None) -> None:
  """A [0, 1]^2 microscope-frame scene."""
  plot_atoms(ax, positions, atomic_numbers)
  _goal_and_beam(ax, goal_position, beam_position)
  ax.set_xlim(0, 1)
  ax.set_ylim(0, 1)
  ax.set_aspect('equal')


def plot_material_frame(ax: raster.Axes, positions: np.ndarray,
                        atomic_numbers: np.ndarray, fov=None,
                        goal_position: Optional[np.ndarray] = None,
                        beam_position: Optional[np.ndarray] = None) -> None:
  """An angstrom material-frame scene; `fov` (lower_left, width, height)
  is drawn as a dashed rectangle."""
  plot_atoms(ax, positions, atomic_numbers)
  _goal_and_beam(ax, goal_position, beam_position)
  if fov is not None:
    ll = _host(fov.lower_left).reshape(-1)[:2]
    width = float(_host(fov.width).reshape(-1)[0])
    height = float(_host(fov.height).reshape(-1)[0])
    ax.rectangle(ll, width, height, edgecolor='k', linestyle='--')
  ax.set_aspect('equal')


def _host(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def material_scene(lattice, offset, theta, si_index):
  """(positions (..., N, 2), atomic numbers (..., N)) of one env's
  scenes, on the host: the lattice's world positions at each pose (offset
  (..., 2), theta (...)) with the silicon site(s) (si_index (..., D), or
  (...) for one dopant) marked."""
  from putting_dune_torch import lattice as lattice_lib

  positions = lattice_lib.world_positions(
      lattice, torch.as_tensor(offset, device=lattice.device),
      torch.as_tensor(theta, device=lattice.device))
  positions = _host(positions)
  numbers = np.full(positions.shape[:-1], constants.CARBON)
  si = np.asarray(_host(si_index), np.int64).reshape(
      positions.shape[:-2] + (-1,))
  np.put_along_axis(numbers, si, constants.SILICON, axis=-1)
  return positions, numbers


def render_env_frame(env, state) -> np.ndarray:
  """Env 0 of a batched state as (500, 500, 3) uint8: its atoms and goal
  in the material frame, the axes set to its field of view."""
  fig = raster.Figure(FIGSIZE)
  (ax,) = fig.subplots()
  material = state.sim.material
  world, numbers = material_scene(env.lattice, material.offset[0],
                                  material.theta[0], material.si_index[0])
  goal = _host(state.goal.position_material)[0]
  plot_material_frame(ax, world, numbers, fov=None, goal_position=goal)
  ll = _host(state.sim.fov.lower_left)[0]
  ur = _host(state.sim.fov.upper_right)[0]
  ax.set_xlim(ll[0], ur[0])
  ax.set_ylim(ll[1], ur[1])
  return fig.rgb()


@dataclasses.dataclass
class Video:
  """An episode's frames as palette indices over one shared palette;
  `save(path)` writes the GIF, `frames` gives (H, W, 3) uint8 arrays."""

  indices: List[np.ndarray]
  palette: raster.Palette
  interval_ms: int = 200

  @property
  def frames(self) -> List[np.ndarray]:
    table = self.palette.array()
    return [table[i] for i in self.indices]

  def to_bytes(self) -> bytes:
    from putting_dune_torch.io import gif

    return gif.encode(self.indices, self.palette.array(), self.interval_ms)

  def save(self, path: str) -> int:
    """Writes the GIF; returns the bytes written."""
    data = self.to_bytes()
    with open(path, 'wb') as f:
      f.write(data)
    return len(data)


def episode_frame(positions, numbers, palette: raster.Palette, step: int,
                  goal_position=None, beam_position=None) -> np.ndarray:
  """One video frame (JAX's animation `draw(i)`) as palette indices."""
  fig = raster.Figure(FIGSIZE, palette=palette)
  (ax,) = fig.subplots()
  plot_material_frame(ax, positions, numbers, goal_position=goal_position,
                      beam_position=beam_position)
  ax.set_title(f'step {step}')
  return fig.render()


def generate_video_from_trajectory(
    positions_sequence: Sequence[np.ndarray],
    atomic_numbers_sequence: Sequence[np.ndarray],
    goal_position: Optional[np.ndarray] = None,
    beam_positions: Optional[Sequence[np.ndarray]] = None,
    interval_ms: int = 200,
) -> Video:
  """An episode video from per-step material-frame snapshots: frame i is
  the material frame of snapshot i, autoscaled, titled 'step i'."""
  palette = raster.Palette()
  indices = [
      episode_frame(positions_sequence[i], atomic_numbers_sequence[i],
                    palette, i, goal_position,
                    None if beam_positions is None else beam_positions[i])
      for i in range(len(positions_sequence))]
  return Video(indices, palette, interval_ms)


def _finish(fig: raster.Figure, save_path: Optional[str]):
  if save_path:
    fig.savefig(save_path)
    return None
  return fig.rgb()


# --- rate-function visualization ----------------------------------------------


def _rate_grid_inputs(grid_range: float, num_points: int,
                      fixed_context: Optional[np.ndarray] = None):
  """(xx, yy, inputs) of `visualize_rates`: a side^2 grid of beam
  positions, each row prefixed with `fixed_context` when given."""
  side = int(np.sqrt(num_points))
  xs = np.linspace(-grid_range, grid_range, side, dtype=np.float32)
  xx, yy = np.meshgrid(xs, xs)
  points = np.stack([xx.ravel(), yy.ravel()], axis=-1)
  if fixed_context is not None and np.size(fixed_context):
    ctx = np.tile(np.asarray(fixed_context, np.float32)[None],
                  (points.shape[0], 1))
    return xx, yy, np.concatenate([ctx, points], axis=-1)
  return xx, yy, points


def visualize_rates(save_path: Optional[str],
                    predict_rates: Callable[[np.ndarray], np.ndarray],
                    grid_range: float = 1.5, num_points: int = 40_000,
                    fixed_context: Optional[np.ndarray] = None):
  """Filled contours of the predicted per-neighbour rates over beam
  positions, one panel a neighbour and one of the total. predict_rates
  maps (N, D) inputs (optionally prefixed with fixed_context) to (N, S)
  rates. Writes a PNG to save_path, or returns the RGB array."""
  xx, yy, inputs = _rate_grid_inputs(grid_range, num_points, fixed_context)
  side = xx.shape[0]
  rates = _host(predict_rates(inputs))
  num_states = rates.shape[-1]
  fig = raster.Figure((5.0 * (num_states + 1), 5.0))
  axes = fig.subplots(1, num_states + 1)
  for k in range(num_states):
    axes[k].contourf(xx, yy, rates[:, k].reshape(side, side), levels=20)
    axes[k].set_title(f'rate -> neighbor {k}')
    axes[k].set_aspect('equal')
  axes[-1].contourf(xx, yy, rates.sum(-1).reshape(side, side), levels=20)
  axes[-1].set_title('total rate')
  axes[-1].set_aspect('equal')
  return _finish(fig, save_path)


def _neighbors3(degrees) -> np.ndarray:
  bond = constants.CARBON_BOND_DISTANCE_ANGSTROMS
  angles = np.deg2rad(degrees)
  return bond * np.stack([np.cos(angles), np.sin(angles)], axis=-1)


def _rates(rate_fn, neighbors, beams) -> np.ndarray:
  """rate_fn on a silicon at the origin, the same three neighbours for
  every beam; tensors on the CPU unless rate_fn says otherwise."""
  batch = beams.shape[0]
  si = torch.zeros((batch, 2))
  nbr = torch.as_tensor(neighbors, dtype=torch.float32)[None].repeat(
      batch, 1, 1)
  return _host(rate_fn(si, nbr, torch.as_tensor(beams)))


def rate_function3_inputs(grid_range: float = 3.0, resolution: int = 100):
  """(xx, yy, neighbors (3, 2), beams (R^2, 2)) of plot_rate_function3."""
  neighbors = _neighbors3([90.0, 210.0, 330.0])
  xs = np.linspace(-grid_range, grid_range, resolution, dtype=np.float32)
  xx, yy = np.meshgrid(xs, xs)
  return xx, yy, neighbors, np.stack([xx.ravel(), yy.ravel()], axis=-1)


def plot_rate_function3(rate_fn, grid_range: float = 3.0,
                        resolution: int = 100,
                        save_path: Optional[str] = None):
  """3-panel per-neighbour rate map for a batched rate function
  (si, neighbors, beam) -> (B, 3): a silicon at the origin with
  neighbours at 90/210/330 degrees."""
  xx, yy, neighbors, beams = rate_function3_inputs(grid_range, resolution)
  rates = _rates(rate_fn, neighbors, beams)
  fig = raster.Figure((15.0, 5.0))
  axes = fig.subplots(1, 3)
  for k in range(3):
    axes[k].contourf(xx, yy, rates[:, k].reshape(resolution, resolution),
                     levels=20)
    axes[k].scatter(neighbors[:, 0], neighbors[:, 1], c='w', s=20)
    axes[k].scatter([0], [0], c='r', s=30)
    axes[k].set_title(f'neighbor {k}')
    axes[k].set_aspect('equal')
  return _finish(fig, save_path)


def rate_along_neighbor_inputs(max_distance: float = 3.0,
                               resolution: int = 200):
  """(ts, neighbors, beams) of plot_rate_along_neighbor_vector3."""
  neighbors = _neighbors3([0.0, 120.0, 240.0])
  ts = np.linspace(0.0, max_distance, resolution, dtype=np.float32)
  return ts, neighbors, np.stack([ts, np.zeros_like(ts)], axis=-1)


def plot_rate_along_neighbor_vector3(rate_fn, max_distance: float = 3.0,
                                     resolution: int = 200,
                                     save_path: Optional[str] = None):
  """Rates along the silicon -> neighbour-0 ray."""
  ts, neighbors, beams = rate_along_neighbor_inputs(max_distance, resolution)
  rates = _rates(rate_fn, neighbors, beams)
  fig = raster.Figure((7.0, 5.0))
  (ax,) = fig.subplots()
  for k in range(3):
    ax.plot(ts, rates[:, k], label=f'neighbor {k}')
  ax.axvline(constants.CARBON_BOND_DISTANCE_ANGSTROMS, linestyle='--',
             color='gray')
  ax.set_xlabel('beam distance along neighbor-0 ray (angstroms)')
  ax.set_ylabel('rate (1/s)')
  ax.legend()
  return _finish(fig, save_path)


def rate_along_arc_inputs(
    radius: float = 0.85 * constants.CARBON_BOND_DISTANCE_ANGSTROMS,
    resolution: int = 360):
  """(thetas, neighbors, beams) of plot_rate_along_arc3."""
  neighbors = _neighbors3([0.0, 120.0, 240.0])
  thetas = np.linspace(0, 2 * np.pi, resolution, dtype=np.float32)
  beams = radius * np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
  return thetas, neighbors, beams


def plot_rate_along_arc3(
    rate_fn, radius: float = 0.85 * constants.CARBON_BOND_DISTANCE_ANGSTROMS,
    resolution: int = 360, save_path: Optional[str] = None):
  """Rates along a circle of `radius` around the silicon."""
  thetas, neighbors, beams = rate_along_arc_inputs(radius, resolution)
  rates = _rates(rate_fn, neighbors, beams)
  fig = raster.Figure((7.0, 5.0))
  (ax,) = fig.subplots()
  for k in range(3):
    ax.plot(np.rad2deg(thetas), rates[:, k], label=f'neighbor {k}')
  for a in (0.0, 120.0, 240.0):
    ax.axvline(a, linestyle='--', color='gray')
  ax.set_xlabel('beam angle (degrees)')
  ax.set_ylabel('rate (1/s)')
  ax.legend()
  return _finish(fig, save_path)


def plot_metrics(metrics, workdir: str) -> List[str]:
  """The rate learner's metric plots (the JAX pipeline's `_plot_metrics`):
  per metric k, `{workdir}/{k}.png` with one curve per model, the average
  and the best (lowest-average) iteration, on a log y axis. Returns the
  paths written."""
  import os

  paths = []
  for k, v in metrics.items():
    v = np.asarray(v)
    fig = raster.Figure((6.4, 4.8))
    (ax,) = fig.subplots()
    for i in range(v.shape[0]):
      ax.plot(v[i])
    ax.plot(v.mean(0), label='Average', linewidth=4)
    ax.axvline(int(v.mean(0).argmin()), label='Best iteration')
    ax.set_yscale('log')
    ax.legend()
    ax.set_title(k.replace('_', ' ').title())
    path = os.path.join(workdir, f'{k}.png')
    fig.savefig(path)
    paths.append(path)
  return paths
