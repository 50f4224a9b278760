"""What the benchmark must not load: JAX, flax, the JAX package and the
repo's JAX-era scripts. Compared by whole top-level module name, since the
port's own name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'putting_dune_tpu',
                       'chip_smoke', 'bench', 'scripts'})


def top_level(name: str) -> str:
  return name.split('.', 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
  """The forbidden top-level names among `modules` (sys.modules)."""
  names = sys.modules if modules is None else modules
  return sorted({top_level(n) for n in names} & FORBIDDEN)
