"""The observation pipeline: each recorded scene (the first call's reset
and the recorded steps) rendered again by the reference (atoms in view,
splat, noise chain with the step's draws, CLAHE, downsample) against the
image the timed path produced.

Number: `obs_pixels_off`, the largest share, over the recorded frames, of
a frame's pixels that differ by more than `TOLERANCE` from the
reference's. A frame's pixels sit in [0, 1]; the kernels and the
reference agree to a few 1e-7 where no Poisson count or CLAHE bin moves.
"""

from __future__ import annotations

import torch

from benchmark.reference import precision as precision_lib
from benchmark.reference import render

TOLERANCE = 1e-3
BLOCK = 128  # frames a block of the reference


def _draws(scene, lo, hi, height, width):
  if 'seeds' in scene:
    return render.draws_from_seeds(scene['seeds'], height, width,
                                   frame_offset=lo, frames=hi - lo)
  if 'uniforms' in scene:
    frames = scene['offset'].shape[0]
    fields = [u for u in scene['uniforms']
              if tuple(u.shape) in ((frames, height, width), (frames, height))]
    return render.draws_from_uniforms([u[lo:hi] for u in fields[-9:]])
  raise ValueError('the step drew no noise: no seeds and no uniforms')


def rendered(sample, config, traffic, precision):
  """The reference's image of every frame of a recorded step."""
  scene = sample['scene']
  size = int(traffic['render_size'])
  frames = scene['offset'].shape[0]
  out = []
  for lo in range(0, frames, BLOCK):
    hi = min(lo + BLOCK, frames)
    part = {k: v[lo:hi] for k, v in scene.items()
            if k not in ('seeds', 'uniforms')}
    out.append(render.observe(
        part, _draws(scene, lo, hi, size, size),
        num_cols=int(config['env']['grid_columns']),
        capacity=int(config['env']['window_capacity']), render_size=size,
        feature_size=int(config['model']['image_size']),
        precision=precision))
  return torch.cat(out)


def small_lambda_share(samples, config, traffic) -> float:
  """Share of rendered pixels whose Poisson mean is below 4 (the noise
  chain's inverted branch), over the recorded steps' clean frames."""
  size = int(traffic['render_size'])
  small = total = 0
  for sample in samples:
    if 'scene' not in sample:
      continue
    scene = sample['scene']
    canon = torch.from_numpy(render.graphene_positions(
        int(config['env']['grid_columns']))).to(scene['offset'].device)
    for lo in range(0, scene['offset'].shape[0], BLOCK):
      s = {k: v[lo:lo + BLOCK] for k, v in scene.items()
           if k not in ('seeds', 'uniforms')}
      ll, ur = s['lower_left'] - s['drift'], s['upper_right'] - s['drift']
      micro, z = render.atoms_in_view(
          canon, s['offset'], s['theta'], s['si_index'], ll, ur,
          int(config['env']['window_capacity']))
      clean = render.splat(micro, z, ur[:, 0] - ll[:, 0], ur[:, 1] - ll[:, 1],
                           s['intensity_exponent'], s['blur_amount'], size)
      lam = clean * s['poisson_rate_multiplier'][:, None, None]
      small += int((lam < 4.0).sum())
      total += lam.numel()
  return small / max(total, 1)


def compare(samples, config, traffic, control: bool) -> dict:
  stated = config['precision']['render']
  worst = 0.0
  for sample in samples:
    if 'scene' not in sample:
      continue  # the first call's accounting
    ref = rendered(sample, config, traffic, 'float32')
    if control:
      got = rendered(sample, config, traffic, precision_lib.LOWER[stated])
    else:
      got = sample['observation']['image'][..., 0]
    if got.shape != ref.shape:
      return {'obs_pixels_off': 1.0}
    off = (torch.abs(got - ref) > TOLERANCE) | ~torch.isfinite(got)
    worst = max(worst, float(off.float().mean(dim=(1, 2)).max()))
  return {'obs_pixels_off': worst}
