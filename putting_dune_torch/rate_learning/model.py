"""The rate-prediction MLP over an ensemble axis.

Port of putting_dune_tpu/rate_learning/model.py. The JAX package vmaps
one flax MLP over the bootstrap ensemble; here the ensemble axis is in
every layer, so M models run as one batched program (a Python loop over M
modules would be M times the launches, and `torch.func.vmap` cannot carry
`nn.BatchNorm1d`'s in-place running-stat update in training):

    x (M, B, C) -> batch norm (per model) -> [Dense -> swish] * H
      -> Dense -> softplus  =  (M, B, num_states + 1)

Outputs [:-1] are directional logits, [-1] the total rate. Parameters keep
flax's layout and names (`Dense_i.kernel` (M, in, out), `Dense_i.bias`,
`BatchNorm_0.scale` / `.bias`, running `BatchNorm_0.mean` / `.var`), so a
flax tree stacked on a model axis carries over without a transpose.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

# flax.linen.BatchNorm(momentum=0.9): running = 0.9 running + 0.1 batch,
# with the biased (E[x^2] - E[x]^2) batch variance and eps 1e-5.
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator,
                  fan_in: Optional[int] = None) -> torch.Tensor:
  """flax's default Dense and Conv init in place: a normal truncated to +-2
  std, rescaled to variance 1 / fan_in (by default tensor.shape[-2], a
  flax-layout kernel's input width), drawn by the inverse CDF as
  jax.random.truncated_normal does."""
  fan_in = tensor.shape[-2] if fan_in is None else fan_in
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
  hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
  u = torch.rand(tensor.shape, generator=generator, device=tensor.device)
  u = lo + (hi - lo) * u
  z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
  with torch.no_grad():
    tensor.copy_(torch.clamp(z, -2.0, 2.0) * std)
  return tensor


class EnsembleDense(nn.Module):
  """M dense layers: y[m] = x[m] @ kernel[m] + bias[m]."""

  def __init__(self, num_models: int, in_features: int, out_features: int,
               device=None):
    super().__init__()
    self.kernel = nn.Parameter(
        torch.empty(num_models, in_features, out_features, device=device))
    self.bias = nn.Parameter(
        torch.zeros(num_models, out_features, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class EnsembleBatchNorm(nn.Module):
  """flax BatchNorm over the batch axis, with each model's own statistics."""

  def __init__(self, num_models: int, features: int, device=None):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(num_models, features, device=device))
    self.bias = nn.Parameter(torch.zeros(num_models, features, device=device))
    self.register_buffer('mean', torch.zeros(num_models, features,
                                             device=device))
    self.register_buffer('var', torch.ones(num_models, features,
                                           device=device))

  def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
    if is_training:
      mean = x.mean(dim=1)
      var = torch.clamp((x * x).mean(dim=1) - mean * mean, min=0.0)
      with torch.no_grad():
        self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    else:
      mean, var = self.mean, self.var
    mul = torch.rsqrt(var + BN_EPSILON) * self.scale
    return (x - mean[:, None, :]) * mul[:, None, :] + self.bias[:, None, :]


class RateMLP(nn.Module):
  """An ensemble of M rate MLPs emitting (num_states + 1) positive outputs.

  `forward(x, is_training)` takes x of shape (M, B, C), or (B, C) fed to
  every model, and returns (M, B, num_states + 1). In training the batch
  norm normalises by each model's batch statistics and updates its running
  ones. Dropout (the JAX package's `dropout_rate` > 0, which no shipped
  config uses) is not ported. `generator` draws the initial kernels.
  """

  def __init__(
      self,
      num_models: int,
      in_features: int,
      hidden_dimensions: Sequence[int] = (64, 64),
      num_states: int = 3,
      batchnorm: bool = True,
      dropout_rate: float = 0.0,
      *,
      device=None,
      generator: Optional[torch.Generator] = None,
  ):
    super().__init__()
    if dropout_rate > 0.0:
      raise NotImplementedError('dropout is not ported to putting_dune_torch')
    self.num_models = num_models
    self.in_features = in_features
    self.hidden_dimensions = tuple(hidden_dimensions)
    self.num_states = num_states
    self.layers = nn.ModuleDict()
    if batchnorm:
      self.layers['BatchNorm_0'] = EnsembleBatchNorm(num_models, in_features,
                                                     device)
    widths = [in_features, *self.hidden_dimensions, num_states + 1]
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
      self.layers[f'Dense_{i}'] = EnsembleDense(num_models, a, b, device)
    if generator is None:
      generator = torch.Generator(device=device).manual_seed(0)
    for name, layer in self.layers.items():
      if name.startswith('Dense'):
        lecun_normal_(layer.kernel, generator)

  @property
  def batchnorm(self) -> bool:
    return 'BatchNorm_0' in self.layers

  def forward(self, x: torch.Tensor, is_training: bool = False
              ) -> torch.Tensor:
    if x.dim() == 2:
      x = x.expand(self.num_models, *x.shape)
    if self.batchnorm:
      x = self.layers['BatchNorm_0'](x, is_training)
    num_dense = len(self.hidden_dimensions) + 1
    for i in range(num_dense):
      x = self.layers[f'Dense_{i}'](x)
      if i == num_dense - 1:
        break
      x = F.silu(x)
    # torch's softplus is the identity above 20, where log(1 + e^x) and x
    # differ by < 2.1e-9, below a float32 ulp there (1.9e-6).
    return F.softplus(x)

  # -- flax trees ---------------------------------------------------------

  def flax_trees(self) -> tuple[dict, dict]:
    """(params, batch_stats) as flax trees of numpy arrays with a leading
    model axis, keys sorted."""
    params, stats = {}, {}
    for name in sorted(self.layers):
      layer = self.layers[name]
      leaves = ('bias', 'scale') if name.startswith('Batch') else (
          'bias', 'kernel')
      params[name] = {leaf: getattr(layer, leaf).detach().cpu().numpy()
                      for leaf in leaves}
      if name.startswith('Batch'):
        stats[name] = {'mean': layer.mean.cpu().numpy(),
                       'var': layer.var.cpu().numpy()}
    return params, stats

  def load_flax_trees(self, params: Mapping, stats: Mapping) -> 'RateMLP':
    """Copies flax params and batch_stats (leading model axis) in place;
    raises on a missing layer or a shape that does not fit."""
    expected = set(self.layers)
    if set(params) != expected:
      raise ValueError(f'flax params hold {sorted(params)}, the model '
                       f'{sorted(expected)}')
    with torch.no_grad():
      for name, layer in self.layers.items():
        leaves = dict(params[name])
        if name.startswith('Batch'):
          leaves.update(stats[name])
        for leaf, value in leaves.items():
          target = getattr(layer, leaf)
          value = torch.from_numpy(np.array(value, np.float32))
          if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f'{name}.{leaf}: checkpoint {tuple(value.shape)}'
                             f' against model {tuple(target.shape)}')
          target.copy_(value)
    return self

  def select(self, model_index: int) -> 'RateMLP':
    """A one-model copy of ensemble member `model_index`."""
    return self.models(model_index, model_index + 1)

  def models(self, start: int, stop: int) -> 'RateMLP':
    """A copy of ensemble members start .. stop - 1."""
    device = next(self.parameters()).device
    part = RateMLP(stop - start, self.in_features, self.hidden_dimensions,
                   self.num_states, self.batchnorm, device=device)
    with torch.no_grad():
      for name, value in self.state_dict().items():
        part.state_dict()[name].copy_(value[start:stop])
    return part


def get_mlp_fn(
    hidden_dimensions: Sequence[int] = (64, 64),
    num_states: int = 3,
    batchnorm: bool = True,
    dropout_rate: float = 0.0,
):
  """(init_fn, apply_fn) in the reference's calling convention, for one
  model, its parameters as flax trees of numpy arrays:

    init_fn(generator, x)                              -> (params, state)
    apply_fn(params, state, generator, x, is_training) -> (outputs,
                                                           new_state)

  `state` holds the batch norm's running statistics (flax 'batch_stats'),
  updated by a training call. x is (B, C) or (C,). The generator draws the
  initial kernels; apply_fn takes one for the convention's dropout key,
  and dropout is not ported.
  """
  hidden_dimensions = tuple(hidden_dimensions)

  def module(x: torch.Tensor, generator=None) -> RateMLP:
    return RateMLP(1, x.shape[-1], hidden_dimensions, num_states, batchnorm,
                   dropout_rate, device=x.device, generator=generator)

  def squeeze(tree):
    return {k: {leaf: v[0] for leaf, v in d.items()} for k, d in tree.items()}

  def unsqueeze(tree):
    return {k: {leaf: np.asarray(v)[None] for leaf, v in d.items()}
            for k, d in tree.items()}

  def init_fn(generator: torch.Generator, x: torch.Tensor):
    params, state = module(x, generator).flax_trees()
    return squeeze(params), squeeze(state)

  def apply_fn(params, state, generator, x: torch.Tensor,
               is_training: bool = True):
    del generator
    squeezed = x.dim() == 1
    if squeezed:
      x = x[None]
    model = module(x).load_flax_trees(unsqueeze(params), unsqueeze(state))
    out = model(x, is_training=is_training)[0]
    new_state = squeeze(model.flax_trees()[1]) if is_training else state
    return (out[0] if squeezed else out), new_state

  return init_fn, apply_fn
