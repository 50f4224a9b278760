"""Data-parallel meshes over torch.distributed: one rank per device.

Port of putting_dune_tpu/parallel/mesh.py. The JAX package runs one process
over N devices and lets GSPMD place a batch-sharded program; the port runs
one process (rank) per device, `nccl` between CUDA devices and `gloo` on
the CPU, and the trainers and the evaluator call the collectives they need
themselves. The axes keep their JAX meaning:

  * `data`: the env batch or the training batch. Each rank steps its share
    of the envs or generates its share of the batch; gradients are
    all-reduced, parameters stay replicated.
  * `model`: the rate learner's bootstrap ensemble. Each rank trains its
    slice of the models; the parameters are all-gathered at the end.

`Mesh` names the axes, their sizes and this rank's device; it spans the
default process group (the whole world). `batch_sharding` /
`replicated_sharding` describe a placement, which `shard_batch` reads:
a leaf whose leading dim divides the axis keeps this rank's block of
rows, anything else is replicated (whole on every rank). `global_batch`
gathers the per-rank blocks back into the global batch.

`initialize_distributed` joins the world: with explicit arguments through
`init_process_group` on `tcp://`, with none from torchrun's environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and as a silent no-op when
there is none or a group already exists. A group that fails to form raises.

`run_cli` is the `--mesh` flag of the eval and PPO CLIs: empty runs the
single-device program; under torchrun (or inside a formed group) the
world it finds; from a plain `python -m ...`, `data:1` forms a one-rank
group over a localhost TCP store in-process and `data:N` spawns N local
ranks of the same command. N is at most the visible devices: CUDA devices,
or CPU cores with `--device=cpu`.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
import subprocess
import sys
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from putting_dune_torch import device as device_lib

INIT_TIMEOUT = datetime.timedelta(seconds=120)
_TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


@dataclasses.dataclass(frozen=True)
class Mesh:
  """Axis names and sizes over the ranks of the default process group
  (or no group at all when torch.distributed is not initialised and the
  mesh has one rank), and this rank's device."""

  axis_names: tuple
  axis_sizes: tuple
  device: torch.device

  @property
  def shape(self) -> dict:
    return dict(zip(self.axis_names, self.axis_sizes))

  @property
  def size(self) -> int:
    return math.prod(self.axis_sizes)

  @property
  def distributed(self) -> bool:
    """True when collectives run (a process group exists), even at one
    rank; False for a one-rank mesh without a group."""
    return dist.is_available() and dist.is_initialized()

  @property
  def rank(self) -> int:
    return dist.get_rank() if self.distributed else 0


def world() -> tuple[int, int]:
  """(rank, world size); (0, 1) without a process group."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank(), dist.get_world_size()
  return 0, 1


def rank_device(device=None) -> torch.device:
  """This rank's device: `device` as resolve_device gives it, with a CUDA
  device pinned to LOCAL_RANK (torchrun's) when it names no index."""
  device = device_lib.resolve_device(device)
  if device.type == 'cuda' and device.index is None:
    device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  return device


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ('data',),
              device=None) -> Mesh:
  """A mesh over the whole world (every rank); the default puts all ranks
  on the first axis. The sizes must multiply to the world size."""
  _, size = world()
  if axis_sizes is None:
    axis_sizes = [size] + [1] * (len(axis_names) - 1)
  if len(axis_sizes) != len(axis_names):
    raise ValueError(f'axis sizes {axis_sizes} and names {axis_names} differ '
                     'in length')
  if math.prod(axis_sizes) != size:
    raise ValueError(f'mesh {dict(zip(axis_names, axis_sizes))} needs '
                     f'{math.prod(axis_sizes)} ranks; the world has {size}')
  return Mesh(tuple(axis_names), tuple(int(s) for s in axis_sizes),
              rank_device(device))


@dataclasses.dataclass(frozen=True)
class Sharding:
  """A placement over a mesh: rows split over `axis`, or replicated
  (axis None)."""

  mesh: Mesh
  axis: Optional[str] = None


def batch_sharding(mesh: Mesh, axis: str = 'data') -> Sharding:
  """Split the leading (batch) dim over `axis`."""
  return Sharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
  return Sharding(mesh, None)


def _map(fn, tree):
  if isinstance(tree, dict):
    return {k: _map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v) for v in tree)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _map(fn, getattr(tree, f.name))
        for f in dataclasses.fields(tree) if f.init})
  return fn(tree)


def _place(x, sharding: Sharding):
  if sharding.axis is None or not isinstance(x, (torch.Tensor, np.ndarray)):
    return x
  n = sharding.mesh.shape[sharding.axis]
  if x.ndim < 1 or x.shape[0] % n:
    return x
  block = x.shape[0] // n
  r = sharding.mesh.rank
  return x[r * block:(r + 1) * block]


def shard_batch(tree, mesh: Mesh, axis: str = 'data'):
  """This rank's rows of every leaf whose leading dim divides the axis;
  scalars and other leaves are replicated (returned whole)."""
  batch = batch_sharding(mesh, axis)
  replicated = replicated_sharding(mesh)

  def put(x):
    shardable = (isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1
                 and x.shape[0] % mesh.shape[axis] == 0)
    return _place(x, batch if shardable else replicated)

  return _map(put, tree)


def local_block(items: Sequence, mesh: Mesh, axis: str = 'data') -> list:
  """This rank's contiguous block of a sequence the axis divides."""
  n = mesh.shape[axis]
  if len(items) % n:
    raise ValueError(f'{len(items)} items do not split over {n} ranks of '
                     f'the {axis!r} axis')
  block = len(items) // n
  r = mesh.rank
  return list(items[r * block:(r + 1) * block])


def gather_blocks(block: list, mesh: Mesh) -> list:
  """The blocks of every rank concatenated in rank order (picklable
  items; every rank gets the whole list)."""
  if not mesh.distributed:
    return list(block)
  out: List[Optional[list]] = [None] * dist.get_world_size()
  dist.all_gather_object(out, list(block))
  return [item for part in out for item in part]


def all_reduce_(tensor: torch.Tensor, mesh: Optional[Mesh],
                op=None) -> torch.Tensor:
  """In-place all-reduce (sum by default) over the mesh's ranks; nothing
  without a mesh or a process group."""
  if mesh is not None and mesh.distributed:
    dist.all_reduce(tensor, op=op or dist.ReduceOp.SUM)
  return tensor


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
  """Whether `flag` holds on any rank (every rank gets the same answer,
  so that they stop or go on together)."""
  if mesh is None or not mesh.distributed:
    return flag
  votes = torch.tensor([float(flag)], device=mesh.device)
  return bool(all_reduce_(votes, mesh) > 0)


def broadcast_object(obj, mesh: Optional[Mesh]):
  """Rank 0's `obj` (picklable) on every rank."""
  if mesh is None or not mesh.distributed:
    return obj
  box = [obj]
  dist.broadcast_object_list(box, src=0)
  return box[0]


def all_reduce_grads_(params: Sequence[torch.Tensor], mesh: Optional[Mesh],
                      average: bool = False) -> None:
  """Sums (or averages) the parameters' gradients over the ranks, in one
  flat buffer."""
  if mesh is None or not mesh.distributed:
    return
  grads = [p.grad for p in params]
  flat = torch.cat([g.reshape(-1) for g in grads])
  dist.all_reduce(flat)
  if average:
    flat /= dist.get_world_size()
  offset = 0
  for g in grads:
    g.copy_(flat[offset:offset + g.numel()].view_as(g))
    offset += g.numel()


def all_gather_cat(tensor: torch.Tensor, mesh: Optional[Mesh],
                   dim: int = 0) -> torch.Tensor:
  """Every rank's equally shaped `tensor`, concatenated along `dim` in
  rank order."""
  if mesh is None or not mesh.distributed:
    return tensor
  parts = [torch.empty_like(tensor)
           for _ in range(dist.get_world_size())]
  dist.all_gather(parts, tensor.contiguous())
  return torch.cat(parts, dim=dim)


def global_batch(tree, mesh: Mesh, axis: str = 'data'):
  """Assembles this rank's (local_batch, ...) leaves into the global
  (ranks x local_batch, ...) batch on every rank (tensors; other leaves
  are returned as they are). At one rank the local batch is the global
  one."""
  def gather(x):
    if not isinstance(x, torch.Tensor) or x.ndim < 1:
      return x
    return all_gather_cat(x, mesh)

  return _map(gather, tree)


def global_batch_multihost(tree, mesh: Mesh, axis: str = 'data'):
  """The process-group assembly of `global_batch`, unconditionally: a
  leaf whose leading dim times the world size divides the axis is
  all-gathered from every rank's host-local block, in rank order (numpy
  leaves through a tensor on this rank's device, and back); any other
  leaf is replicated as it is. At one rank the host-local batch is the
  global one, so `global_batch_multihost(shard_batch(x, mesh), mesh)` is
  x on every world size."""
  _, size = world()
  axis_size = mesh.shape[axis]

  def gather(x):
    if (not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim < 1
        or (x.shape[0] * size) % axis_size):
      return x
    if isinstance(x, np.ndarray):
      local = torch.as_tensor(x, device=mesh.device)
      return all_gather_cat(local, mesh).cpu().numpy()
    return all_gather_cat(x, mesh)

  return _map(gather, tree)


def device_count(device=None) -> int:
  """Devices a mesh spec may name: CUDA devices, or CPU cores for the
  CPU."""
  device = device_lib.resolve_device(device)
  if device.type == 'cuda':
    return torch.cuda.device_count()
  return os.cpu_count() or 1


def _spec_size(spec: str, device=None) -> int:
  """The rank count a spec names, checked by the JAX package's rules."""
  name, _, size = spec.partition(':')
  if name != 'data':
    raise ValueError(
        f"Unknown mesh axis {name!r} in spec {spec!r}; the CLI supports "
        "'data' or 'data:N'.")
  available = world()[1] if _in_world() else device_count(device)
  if not size:
    return available
  n = int(size)
  if n < 1 or n > available:
    raise ValueError(
        f'mesh spec {spec!r} wants {n} devices; {available} available')
  return n


def _in_world() -> bool:
  return (dist.is_available() and dist.is_initialized()) or all(
      k in os.environ for k in _TORCHRUN_ENV)


def parse_mesh_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
  """A CLI mesh spec: '' / None -> None (the single-device program),
  'data' -> a 1-D mesh over every rank, 'data:N' -> over N ranks, which
  must be the world's size. Without a process group only a one-rank mesh
  can be built (run_cli forms the group first)."""
  if not spec:
    return None
  n = _spec_size(spec, device)
  _, size = world()
  if n != size:
    raise ValueError(
        f'mesh spec {spec!r} wants {n} ranks; the world has {size} (launch '
        'the ranks first: the CLIs do, or torchrun)')
  return make_mesh([n], ('data',), device=device)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> None:
  """Joins this process to the world: `nccl` when `device` is CUDA,
  `gloo` on the CPU. Explicit arguments (all three) form the group on
  tcp://coordinator_address; with none, torchrun's environment does, and
  without that or inside a formed group this is a no-op."""
  if dist.is_initialized():
    return
  given = (coordinator_address, num_processes, process_id)
  if any(v is not None for v in given):
    if any(v is None for v in given):
      raise ValueError('--coordinator_address, --num_processes and '
                       '--process_id go together')
    address = coordinator_address
    if '://' not in address:
      address = f'tcp://{address}'
    dist.init_process_group(_backend(device), init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=INIT_TIMEOUT)
    return
  if all(k in os.environ for k in _TORCHRUN_ENV):
    dist.init_process_group(_backend(device), init_method='env://',
                            timeout=INIT_TIMEOUT)


def _backend(device) -> str:
  """'nccl' for CUDA (this rank's device made current), else 'gloo'."""
  return 'nccl' if rank_device(device).type == 'cuda' else 'gloo'


def shutdown() -> None:
  if dist.is_initialized():
    dist.destroy_process_group()


def process_local_batch_size(global_batch_size: int) -> int:
  """This rank's share of a global batch."""
  _, count = world()
  if global_batch_size % count:
    raise ValueError(f'global batch {global_batch_size} not divisible by '
                     f'process count {count}')
  return global_batch_size // count


def process_data_seed(seed: int) -> int:
  """A per-rank data seed for disjoint generated-data streams: `seed`
  itself at world 1 (the non-distributed streams bit for bit), else the
  rank folded in."""
  rank, count = world()
  if count == 1:
    return seed
  return int(np.random.SeedSequence([int(seed), rank]).generate_state(1)[0])


def free_port() -> int:
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def run_cli(spec: str, device, fn: Callable[[Optional[Mesh]], Any],
            module: str, argv: Sequence[str]) -> Any:
  """Runs `fn(mesh)` for a CLI's --mesh (see the module docstring); for
  `data:N` from a plain process, spawns N ranks of `python -m module
  *argv` (the command line that gives the run) and returns None once all
  have exited 0 (raises otherwise)."""
  if not spec:
    return fn(None)
  if _in_world():
    initialize_distributed(device=device)
    return fn(parse_mesh_spec(spec, device))
  n = _spec_size(spec, device)
  if n == 1:
    initialize_distributed(f'localhost:{free_port()}', 1, 0, device=device)
    try:
      return fn(parse_mesh_spec(spec, device))
    finally:
      shutdown()
  port = free_port()
  procs = []
  for rank in range(n):
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
               WORLD_SIZE=str(n), MASTER_ADDR='localhost',
               MASTER_PORT=str(port))
    procs.append(subprocess.Popen([sys.executable, '-m', module, *argv],
                                  env=env))
  try:
    while True:
      codes = [p.poll() for p in procs]
      # A failed rank would leave the others waiting in a collective.
      if all(c is not None for c in codes) or any(codes):
        break
      time.sleep(0.2)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  if any(codes):
    raise RuntimeError(f'{module} ranks exited with codes {codes}')
  return None
