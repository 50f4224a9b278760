"""The vision planner, stage by stage on the inputs the timed path handed
each stage: the reference UNet, with the shipped weights read by its own
reader, on the frames the policy was handed, against the detector's
logits; the reference planner (geometry from the class probabilities,
the expected-progress objective over the candidate grid) on the softmax
of those logits, against the action the policy took.

Numbers: `detector_rel_rms`, the largest over frames of the RMS of the
logit gap over the RMS of the reference's logits; `planner_gap`, the
largest over frames of the reference planner's best score less its score
of the program's beam offset, in angstroms of expected progress.

The control puts the reference in the program's place one precision
below the configuration's: the UNet in bfloat16 (the detector runs in
TF32), the planner with every intermediate rounded to TF32 (it runs in
float32) on the control detector's probabilities."""

from __future__ import annotations

import functools
import os

import torch

from benchmark.lib import cells
from benchmark.reference import flax_msgpack
from benchmark.reference import networks
from benchmark.reference import planner
from benchmark.reference import precision as precision_lib

BLOCK = 25  # frames a block of the reference UNet


@functools.lru_cache(maxsize=2)
def _params(path: str, device: str):
  return networks.tensors(flax_msgpack.load(os.path.join(cells.ROOT, path)),
                          torch.device(device))


def _logits(params, image, precision):
  return torch.cat([networks.unet_logits(params, image[lo:lo + BLOCK],
                                         precision)
                    for lo in range(0, image.shape[0], BLOCK)])


def _grid(cfg, device):
  return torch.as_tensor(planner.candidates(cfg['max_distance_angstroms']),
                         device=device)


def _scores(probs, goal, cfg, beam, precision='float32'):
  """The planner's scores of beam offsets (B, K, 2) from class
  probabilities (B, S, S, 3)."""
  theta0 = planner.bond_orientation(probs[..., 2], probs[..., 1], precision)
  return planner.scores(theta0, goal, beam, float(cfg['dwell_seconds']),
                        precision)


def compare(samples, config, traffic, control: bool) -> dict:
  cfg = config['planner']
  rel, gap = 0.0, 0.0
  for sample in samples:
    if 'policy_input' not in sample:
      continue  # the reset: no action taken
    obs = sample['policy_input']
    image, goal = obs['image'], obs['goal_delta_angstroms']
    params = _params(config['detector_weights'], str(image.device))
    ref = _logits(params, image, 'float32')
    grid = _grid(cfg, image.device)[None].expand(image.shape[0], -1, -1)
    if control:
      got = _logits(params, image,
                    precision_lib.LOWER[config['precision']['detector']])
      probs = torch.softmax(got, dim=-1)
      pick = torch.argmax(_scores(
          probs, goal, cfg, grid,
          precision_lib.LOWER[config['precision']['planner']]), -1)
      action = grid[0][pick] / cfg['max_distance_angstroms']
    else:
      got, action = sample['logits'], sample['action']
      probs = torch.softmax(got, dim=-1)
    if got.shape != ref.shape:
      return {'detector_rel_rms': 1.0, 'planner_gap': 1e30}
    diff = torch.nan_to_num(got - ref, nan=1e30)
    per_frame = (diff.square().mean(dim=(1, 2, 3)).sqrt()
                 / ref.square().mean(dim=(1, 2, 3)).sqrt())
    rel = max(rel, float(per_frame.max()))
    beam = action * cfg['max_distance_angstroms']
    lost = (_scores(probs, goal, cfg, grid).amax(-1)
            - _scores(probs, goal, cfg, beam[:, None, :])[:, 0])
    lost = torch.where(torch.isfinite(lost), lost, torch.full_like(lost, 1e30))
    gap = max(gap, float(lost.max()))
  return {'detector_rel_rms': rel, 'planner_gap': gap}
