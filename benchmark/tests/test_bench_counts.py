"""The benchmark's FLOP and byte counters against hand counts."""

import pytest

from benchmark.lib import flops
from benchmark.lib import peaks


def test_actor_critic_flops_at_128():
  # Multiply-adds by hand: conv 1->16 on 64^2, 16->32 on 32^2, 32->64 on
  # 16^2 (3x3), dense 16386->256, 256->256, heads 256->2 and 256->1.
  macs = (1 * 16 * 9 * 64 * 64 + 16 * 32 * 9 * 32 * 32
          + 32 * 64 * 9 * 16 * 16 + 16386 * 256 + 256 * 256 + 256 * 3)
  assert macs == 14_288_128
  assert flops.actor_critic(128) == 2 * macs == 28_576_256


def test_unet_flops_by_hand():
  # features (2, 4) on a 4^2 frame: down 1->2 at 4^2, bottleneck 2->4 at
  # 2^2, transposed 4->2 over the 2^2 input, up block 4->2 at 4^2, head.
  macs = (1 * 2 * 9 * 16 + 2 * 4 * 9 * 4 + 4 * 2 * 9 * 4 + 4 * 2 * 9 * 16
          + 2 * 3 * 16)
  assert flops.unet(4, features=(2, 4)) == 2 * macs


def test_shipped_unet_flops_at_256():
  assert flops.unet(256) == 58_082_721_792


def test_noise_chain_bound_is_the_operations_bound():
  frames, side = 1024, 512
  npx = frames * side * side
  f32 = npx * (61 + 0.5 * 62 + 0.5 * 6)
  expected = f32 / 67e12 + npx * 166 / 33.5e12
  assert peaks.noise_chain_bound_s(frames, side, side, 0.5) == pytest.approx(
      expected, rel=1e-12)
  assert expected > 8.0 * npx / 3.35e12


def test_clahe_bounds_are_the_bytes_bounds():
  npx = 100 * 512 * 512
  tables = 100 * 64 * 256
  assert peaks.clahe_hist_lut_bound_s(100, 512, 512) == pytest.approx(
      (4.0 * npx + 8 * tables) / 3.35e12, rel=1e-12)
  assert peaks.clahe_remap_bound_s(100, 512, 512) == pytest.approx(
      (8.0 * npx + 4 * tables) / 3.35e12, rel=1e-12)
