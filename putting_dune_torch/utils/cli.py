"""Dataclass-driven CLI for the train entry points.

Port of putting_dune_tpu/utils/cli.py: every field of the config
dataclass becomes a flag, by the JAX package's rules (booleans as
--flag / --no-flag, tuples comma-separated, fields without a default
required), plus --device ('cuda' by default, 'cpu' to run here). A
None-default field parses by its annotation: a tuple comma-separated, an
Optional[float] or Optional[int] as that number (the JAX package passes
those on as strings), anything else as a string.

The JAX package's multi-process flags (--coordinator_address,
--num_processes, --process_id) parse, and any value raises: the
multi-process trainers wait for the multi-GPU slice.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Optional, Sequence

MULTI_PROCESS_FLAGS = ('coordinator_address', 'num_processes', 'process_id')


def _comma_tuple(elem):
  return lambda s: tuple(elem(v) for v in s.split(','))


def _add_field_arg(parser: argparse.ArgumentParser, field) -> None:
  name = f'--{field.name}'
  if field.default is not dataclasses.MISSING:
    default = field.default
  elif field.default_factory is not dataclasses.MISSING:
    default = field.default_factory()
  else:
    default = dataclasses.MISSING
  if isinstance(default, bool):
    parser.add_argument(name, action=argparse.BooleanOptionalAction,
                        default=default)
  elif isinstance(default, tuple):
    elem = type(default[0]) if default else float
    parser.add_argument(name, type=_comma_tuple(elem), default=default,
                        help='comma-separated')
  elif default is dataclasses.MISSING:
    parser.add_argument(name, required=True)
  elif default is None:
    annotation = str(field.type).lower()
    if 'tuple' in annotation:
      parser.add_argument(name, type=_comma_tuple(float), default=None,
                          help='comma-separated')
    elif 'float' in annotation:
      parser.add_argument(name, type=float, default=None)
    elif 'int' in annotation:
      parser.add_argument(name, type=int, default=None)
    else:
      parser.add_argument(name, default=None)
  else:
    parser.add_argument(name, type=type(default), default=default)


def parse(config_cls: type, description: str,
          argv: Optional[Sequence[str]] = None) -> tuple[Any, Optional[str]]:
  """(config, device) from the command line; raises NotImplementedError
  when a multi-process flag is given."""
  parser = argparse.ArgumentParser(description=description)
  for field in dataclasses.fields(config_cls):
    _add_field_arg(parser, field)
  parser.add_argument('--device', default=None,
                      help="'cuda' (default) or 'cpu'.")
  parser.add_argument('--coordinator_address', default=None)
  parser.add_argument('--num_processes', type=int, default=None)
  parser.add_argument('--process_id', type=int, default=None)
  ns = vars(parser.parse_args(argv))
  device = ns.pop('device')
  given = [f'--{k}' for k in MULTI_PROCESS_FLAGS if ns.pop(k) is not None]
  if given:
    raise NotImplementedError(
        f'{", ".join(given)}: multi-process training is not ported yet '
        '(ROADMAP queue 1, multi-GPU); run one process on one device.')
  return config_cls(**ns), device


def run_train_cli(config_cls: type, train_fn: Callable[..., Any],
                  description: str,
                  argv: Optional[Sequence[str]] = None) -> Any:
  """Parses `config_cls` fields as flags and runs
  `train_fn(config, device=..., progress=...)`, printing each epoch's
  summary."""
  config, device = parse(config_cls, description, argv)

  def progress(epoch, summary):
    items = ' '.join(f'{k}={v:.5f}' for k, v in summary.items())
    print(f'epoch {epoch}: {items}', flush=True)

  return train_fn(config, device=device, progress=progress)
