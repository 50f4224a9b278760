"""GNN drift aligner over multi-frame atom point clouds.

Port of putting_dune_tpu/graph_alignment/model.py, batch-first (the JAX
module takes one graph and `batched_apply` vmaps it; here every tensor
carries a leading batch axis, and a single graph is taken too). A graph
is T frames of atom positions (angstroms) with a fixed node capacity and
a mask; each node's features are its position less the graph's masked
centroid, its frame one-hot and Z / 14. Message passing runs over a static
k-nearest-neighbour edge table, `num_layers` rounds of an edge MLP
(senders, receivers, relative position, distance), the masked mean of the
messages, a node MLP, LayerNorm (eps 1e-6) and a residual. Heads: per
frame the masked mean of the nodes through an MLP to a (T, 2) drift, and
per node an MLP to a (N, 2) residual. MLPs are Dense layers with SiLU
between them.

`knn_edges` equals the JAX package's `jax.lax.top_k(-d2, k)` index for
index: a stable sort of the squared distances puts the lower index first
among equal distances, as top_k does (masked nodes are at distance inf,
each node's own entry at 1e9).

`params_from_flax` / `params_to_flax` carry the flax parameter tree both
ways; the shipped `graph_aligner/params.msgpack` (width 64, 3 layers,
input 5 so 2 frames, k 8) loads with `from_flax`.
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from putting_dune_torch.agents import eval_agent

SHIPPED_DIR = os.path.join(eval_agent.MODEL_WEIGHTS_DIR, 'graph_aligner')
LAYER_NORM_EPS = 1e-6


def knn_edges(positions: torch.Tensor, mask: torch.Tensor, k: int
              ) -> torch.Tensor:
  """(..., N, k) int64 neighbour indices of each node, nearest first.

  Masked nodes are never neighbours of a node that has k valid ones; a
  node's own index comes only after every valid node (their messages are
  masked out downstream).
  """
  n = positions.shape[-2]
  d2 = torch.sum(torch.square(positions[..., :, None, :]
                              - positions[..., None, :, :]), dim=-1)
  d2 = d2 + torch.where(mask[..., None, :], 0.0, float('inf'))
  d2 = d2 + torch.eye(n, device=positions.device) * 1e9
  return torch.argsort(d2, dim=-1, stable=True)[..., :k]


class MLP(nn.Module):
  """Dense layers with SiLU between them (flax `_MLP`)."""

  def __init__(self, in_features: int, widths: Sequence[int]):
    super().__init__()
    sizes = (in_features, *widths)
    self.dense = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(self.dense):
      x = layer(x)
      if i + 1 < len(self.dense):
        x = F.silu(x)
    return x


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x (B, N, F) at idx (B, N, k) -> (B, N, k, F)."""
  b = torch.arange(x.shape[0], device=x.device)[:, None, None]
  return x[b, idx]


class MessagePassingLayer(nn.Module):
  """One edge -> node message-passing round, LayerNorm and residual."""

  def __init__(self, in_features: int, width: int = 64):
    super().__init__()
    self.edge_mlp = MLP(2 * in_features + 3, (width, width))
    self.node_mlp = MLP(in_features + width, (width, width))
    self.norm = nn.LayerNorm(width, eps=LAYER_NORM_EPS)

  def forward(self, nodes, positions, edge_idx, mask):
    senders = _gather(nodes, edge_idx)  # (B, N, k, F)
    rel = _gather(positions, edge_idx) - positions[:, :, None, :]
    dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    receivers = nodes[:, :, None, :].expand_as(senders)
    messages = self.edge_mlp(torch.cat([senders, receivers, rel, dist], -1))
    valid = _gather(mask[..., None], edge_idx)[..., 0] & mask[:, :, None]
    messages = torch.where(valid[..., None], messages, 0.0)
    agg = messages.sum(dim=2) / torch.clamp(
        valid.sum(dim=2, keepdim=True), min=1).to(messages.dtype)
    out = self.norm(self.node_mlp(torch.cat([nodes, agg], -1)))
    if nodes.shape[-1] == out.shape[-1]:
      out = out + nodes
    return out


class AlignmentGraphNetwork(nn.Module):
  """Stacked message passing + global drift / local jitter heads."""

  def __init__(self, num_frames: int = 2, width: int = 64,
               num_layers: int = 3, k: int = 8):
    super().__init__()
    self.num_frames, self.width, self.k = num_frames, width, k
    self.embed = MLP(2 + num_frames + 1, (width,))
    self.layers = nn.ModuleList(
        MessagePassingLayer(width, width) for _ in range(num_layers))
    self.global_head = MLP(width, (width, 2))
    self.local_head = MLP(width, (width, 2))

  def forward(self, positions, frame_ids, atomic_numbers, mask
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (B, N, 2), frame_ids (B, N) int, atomic_numbers (B, N)
    int, mask (B, N) bool (or one graph without the batch axis) ->
    (global (B, T, 2), local (B, N, 2))."""
    single = positions.dim() == 2
    if single:
      positions, frame_ids, atomic_numbers, mask = (
          x[None] for x in (positions, frame_ids, atomic_numbers, mask))
    maskf = mask.to(positions.dtype)
    count = torch.clamp(maskf.sum(-1), min=1.0)[:, None, None]
    centered = positions - torch.where(
        mask[..., None], positions, 0.0).sum(-2, keepdim=True) / count
    frame_onehot = F.one_hot(frame_ids.long(), self.num_frames).to(
        positions.dtype)
    z = (atomic_numbers.to(positions.dtype) / 14.0)[..., None]
    nodes = self.embed(torch.cat([centered, frame_onehot, z], -1))
    edge_idx = knn_edges(positions, mask, self.k)
    for layer in self.layers:
      nodes = layer(nodes, positions, edge_idx, mask)
    frame_mask = frame_onehot * maskf[..., None]  # (B, N, T)
    pooled = torch.einsum('bnf,bnt->btf', nodes, frame_mask) / torch.clamp(
        frame_mask.sum(-2)[..., None], min=1.0)
    global_out = self.global_head(pooled)
    local_out = self.local_head(nodes)
    if single:
      return global_out[0], local_out[0]
    return global_out, local_out


def batched_apply(model: AlignmentGraphNetwork, batch: Mapping
                  ) -> tuple[torch.Tensor, torch.Tensor]:
  """The network on a batch dict of stacked graphs."""
  return model(batch['positions'], batch['frame_ids'],
               batch['atomic_numbers'], batch['mask'])


def _flax_names(num_layers: int) -> dict[str, str]:
  """torch module prefix -> flax path (slash-separated)."""
  names = {'embed': '_MLP_0', 'global_head': '_MLP_1',
           'local_head': '_MLP_2'}
  for i in range(num_layers):
    names[f'layers.{i}.edge_mlp'] = f'MessagePassingLayer_{i}/_MLP_0'
    names[f'layers.{i}.node_mlp'] = f'MessagePassingLayer_{i}/_MLP_1'
  return names


def _num_layers(flax_or_state, flax: bool) -> int:
  if flax:
    return sum(1 for k in flax_or_state if k.startswith('MessagePassing'))
  return len({k.split('.')[1] for k in flax_or_state
              if k.startswith('layers.')})


def params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
  """The flax AlignmentGraphNetwork tree as a state_dict."""
  t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
  num_layers = _num_layers(params, True)
  state = {}
  for prefix, path in _flax_names(num_layers).items():
    node = params
    for part in path.split('/'):
      node = node[part]
    for j in range(len(node)):
      dense = node[f'Dense_{j}']
      state[f'{prefix}.dense.{j}.weight'] = t(np.asarray(dense['kernel']).T)
      state[f'{prefix}.dense.{j}.bias'] = t(dense['bias'])
  for i in range(num_layers):
    norm = params[f'MessagePassingLayer_{i}']['LayerNorm_0']
    state[f'layers.{i}.norm.weight'] = t(norm['scale'])
    state[f'layers.{i}.norm.bias'] = t(norm['bias'])
  return state


def params_to_flax(model_or_state) -> dict:
  """An AlignmentGraphNetwork (or its state_dict, or gradients by
  parameter name) as the flax parameter tree of float32 numpy arrays."""
  state = (model_or_state.state_dict()
           if isinstance(model_or_state, nn.Module) else model_or_state)
  arr = lambda x: x.detach().to('cpu', torch.float32).numpy().copy()  # noqa: E731
  num_layers = _num_layers(state, False)
  params: dict = {}
  for prefix, path in _flax_names(num_layers).items():
    node = params
    for part in path.split('/'):
      node = node.setdefault(part, {})
    j = 0
    while f'{prefix}.dense.{j}.weight' in state:
      weight = arr(state[f'{prefix}.dense.{j}.weight'])
      node[f'Dense_{j}'] = {'kernel': np.ascontiguousarray(weight.T),
                            'bias': arr(state[f'{prefix}.dense.{j}.bias'])}
      j += 1
  for i in range(num_layers):
    params[f'MessagePassingLayer_{i}']['LayerNorm_0'] = {
        'scale': arr(state[f'layers.{i}.norm.weight']),
        'bias': arr(state[f'layers.{i}.norm.bias'])}
  return params


def from_flax(params: Mapping, k: int = 8) -> AlignmentGraphNetwork:
  """An AlignmentGraphNetwork holding a flax tree; the width, depth and
  frame count are read from the kernels (k is not in the tree)."""
  embed = params['_MLP_0']['Dense_0']['kernel']
  model = AlignmentGraphNetwork(
      num_frames=embed.shape[0] - 3, width=embed.shape[1],
      num_layers=_num_layers(params, True), k=k)
  model.load_state_dict(params_from_flax(params))
  return model.eval()
