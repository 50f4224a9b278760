"""Device-mesh parallelism utilities."""

from putting_dune_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    'batch_sharding',
    'make_mesh',
    'replicated_sharding',
    'shard_batch',
]
