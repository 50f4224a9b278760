"""Batched kinetic-Monte-Carlo engine for dopant transitions.

Port of putting_dune_tpu/kmc.py `apply_control` and `apply_control_multi`.
The JAX package runs the whole batch inside one lax.while_loop; here the
same body is torch ops in a Python loop that runs while any lane is
active: one `kmc.round` span a round, each after the host has read
whether any lane is active (`sync.kmc_active`). The laws are the JAX package's:

  * waiting time dt = -log1p(-u0) / total, clipped at 3600 s;
  * an event fires when elapsed + dt <= dwell, the loop continues while
    elapsed + dt < dwell;
  * the successor is drawn by inverse CDF on the cumulative rates;
  * a per-lane `max_events` cap stops a lane and flags it truncated;
  * `record_events` keeps the first E event times and sites.

Distributions match the JAX package, not bitstreams (threefry there,
torch's Philox here).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from putting_dune_torch import constants
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch.utils import profiling


def _any_active(active: torch.Tensor) -> bool:
  """Whether another event round runs: the loop's one host sync a round."""
  with profiling.span('sync.kmc_active'):
    return bool(active.any())


class KMCResult(NamedTuple):
  """Outcome of one beam control on a batch of materials.

  Attributes:
    si_index: (B,) int64 final silicon site per environment.
    num_transitions: (B,) int32 events that fired during the dwell.
    event_times: (E, B) float32 times of the first E events (inf = none).
    event_sites: (E, B) int64 site after each recorded event (-1 = none).
    truncated: (B,) bool, True where the lane hit max_events with dwell
      time remaining.
  """

  si_index: torch.Tensor
  num_transitions: torch.Tensor
  event_times: torch.Tensor
  event_sites: torch.Tensor
  truncated: torch.Tensor


def apply_control(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    offset: torch.Tensor,
    theta: torch.Tensor,
    si_index: torch.Tensor,
    beam_position: torch.Tensor,
    dwell_seconds: torch.Tensor,
    rate_fn: rates_lib.RateFunction,
    *,
    record_events: int = 0,
    max_events: Optional[int] = None,
) -> KMCResult:
  """Simulates one beam exposure on a batch of B environments.

  Args:
    gen: generator on the tensors' device (consumed).
    lattice: static lattice.
    offset: (B, 2) per-env lattice offset.
    theta: (B,) per-env lattice rotation.
    si_index: (B,) current silicon site.
    beam_position: (B, 2) beam position in the MATERIAL frame.
    dwell_seconds: (B,) exposure duration.
    rate_fn: batched rate function (si_pos, neighbor_pos, beam_pos)->(B, 3).
    record_events: record up to this many events per env.
    max_events: optional per-env cap on events during one dwell.

  Returns:
    KMCResult.
  """
  device = si_index.device
  batch = si_index.shape[0]
  num_record = max(int(record_events), 0)
  ev_t = torch.full((num_record, batch), float('inf'), device=device)
  ev_s = torch.full((num_record, batch), -1, dtype=torch.int64,
                    device=device)

  cos_t = torch.cos(theta)[:, None]
  sin_t = torch.sin(theta)[:, None]
  si = si_index.to(torch.int64)
  elapsed = torch.zeros((batch,), device=device)
  active = dwell_seconds > 0.0
  count = torch.zeros((batch,), dtype=torch.int32, device=device)
  trunc = torch.zeros((batch,), dtype=torch.bool, device=device)
  slots = torch.arange(num_record, device=device)[:, None]

  while _any_active(active):
    with profiling.span('kmc.round'):
      nbr_idx = lattice.neighbors[si]  # (B, 3)
      idx4 = torch.cat([si[:, None], nbr_idx], dim=-1)
      canon = lattice.positions[idx4] + offset[:, None, :]  # (B, 4, 2)
      cx, cy = canon[..., 0], canon[..., 1]
      world = torch.stack(
          [cx * cos_t - cy * sin_t, cx * sin_t + cy * cos_t], dim=-1
      )
      si_pos, nbr_pos = world[:, 0, :], world[:, 1:, :]

      rates = rate_fn(si_pos, nbr_pos, beam_position)
      cum = torch.cumsum(rates, dim=-1)
      total_rate = cum[:, -1]

      u = torch.rand((batch, 2), generator=gen, device=device)
      dt = -torch.log1p(-u[:, 0]) / total_rate
      dt = torch.clamp(dt, max=constants.MAX_WAITING_TIME_SECONDS)
      new_elapsed = elapsed + dt

      fired = active & (new_elapsed <= dwell_seconds)
      choice = torch.sum(
          (u[:, 1:] * total_rate[:, None]) >= cum[:, :2], dim=-1
      )
      candidate = torch.gather(nbr_idx, 1, choice[:, None])[:, 0]
      new_si = torch.where(fired, candidate, si)
      new_count = count + fired.to(torch.int32)

      if num_record > 0:
        write = (slots == count[None, :]) & fired[None, :]
        ev_t = torch.where(write, new_elapsed[None, :], ev_t)
        ev_s = torch.where(write, new_si[None, :], ev_s)

      new_active = active & (new_elapsed < dwell_seconds)
      if max_events is not None:
        hit_cap = new_count >= max_events
        trunc = trunc | (new_active & hit_cap)
        new_active = new_active & ~hit_cap
      elapsed = torch.where(active, new_elapsed, elapsed)
      si, count, active = new_si, new_count, new_active

  return KMCResult(si, count, ev_t, ev_s, trunc)


class MultiDopantKMCResult(NamedTuple):
  """Outcome for multi-dopant exposures.

  Attributes:
    si_indices: (B, D) int64 final dopant sites.
    num_transitions: (B,) int32 total events across all dopants.
    truncated: (B,) bool, True where the lane hit max_events with dwell
      time remaining.
  """

  si_indices: torch.Tensor
  num_transitions: torch.Tensor
  truncated: torch.Tensor


def apply_control_multi(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    offset: torch.Tensor,
    theta: torch.Tensor,
    si_indices: torch.Tensor,
    beam_position: torch.Tensor,
    dwell_seconds: torch.Tensor,
    rate_fn: rates_lib.RateFunction,
    *,
    max_events: Optional[int] = None,
) -> MultiDopantKMCResult:
  """KMC over D dopants per environment (multi-channel KMC).

  Each round evaluates all D dopants' neighbor rates, draws one
  exponential waiting time from the summed rate (Exp(1) / max(total,
  1e-30), clipped at 3600 s) and moves one (dopant, neighbor) pair chosen
  categorically over the flat (B, D*3) rates. Moves onto sites occupied by
  another dopant have rate 0. The categorical draw is an inverse-cdf draw
  (the JAX package draws by Gumbel argmax; the law is the same).

  Args:
    si_indices: (B, D) current dopant sites.
    max_events: optional per-env cap on total events during the dwell.
    Everything else as apply_control; beam_position (B, 2) material frame.
  """
  device = si_indices.device
  batch, num_dopants = si_indices.shape
  si = si_indices.to(torch.int64)
  elapsed = torch.zeros((batch,), device=device)
  active = dwell_seconds > 0.0
  count = torch.zeros((batch,), dtype=torch.int32, device=device)
  trunc = torch.zeros((batch,), dtype=torch.bool, device=device)
  dopant_ids = torch.arange(num_dopants, device=device)[None, :]

  while _any_active(active):
    with profiling.span('kmc.round'):
      nbr_idx = lattice.neighbors[si]  # (B, D, 3)
      si_pos = lattice_lib.site_position(lattice, si, offset, theta)
      nbr_pos = lattice_lib.site_position(lattice, nbr_idx, offset, theta)
      rates = torch.stack(
          [rate_fn(si_pos[:, d], nbr_pos[:, d], beam_position)
           for d in range(num_dopants)], dim=1)  # (B, D, 3)

      occupied = (nbr_idx[..., None] == si[:, None, None, :]).any(-1)
      rates = torch.where(occupied, torch.zeros_like(rates), rates)

      flat_rates = rates.reshape(batch, num_dopants * 3)
      cum = torch.cumsum(flat_rates, dim=-1)
      total = cum[:, -1]
      u = torch.rand((batch, 2), generator=gen, device=device)
      dt = -torch.log1p(-u[:, 0]) / torch.clamp(total, min=1e-30)
      dt = torch.clamp(dt, max=constants.MAX_WAITING_TIME_SECONDS)
      new_elapsed = elapsed + dt
      fired = active & (new_elapsed <= dwell_seconds)

      # Inverse cdf: the first channel whose cumulative rate exceeds
      # u * total; zero-rate channels are never chosen.
      choice = torch.sum(
          (u[:, 1:] * total[:, None]) >= cum[:, :-1], dim=-1)
      dopant = choice // 3
      target = torch.gather(
          nbr_idx.reshape(batch, -1), 1, choice[:, None])[:, 0]
      si = torch.where(
          (dopant_ids == dopant[:, None]) & fired[:, None], target[:, None], si)
      count = count + fired.to(torch.int32)
      active = active & (new_elapsed < dwell_seconds)
      if max_events is not None:
        hit_cap = count >= max_events
        trunc = trunc | (active & hit_cap)
        active = active & ~hit_cap
      elapsed = torch.where(active | fired, new_elapsed, elapsed)

  return MultiDopantKMCResult(si, count, trunc)
