"""The JAX package's public names that the port keeps: every name a
subpackage of the JAX package re-exports (its `__all__`), the experiment
module path `experiments` with the registry's constructor types, the
perception trainers' `load_arch`, `env.features.Features`, the rate
model's `ApplyFn` / `Params` / `State`, and
`parallel.mesh.global_batch_multihost`, at one rank and on a two-rank
`gloo` world (tests/torch_dist_worker.py in subprocesses). Every module of
the port imports alone in a fresh interpreter (no import cycle)."""

import ast
import collections.abc
import importlib
import json
import os
import pathlib
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch

from putting_dune_torch.atom_detection import train as t_det_train
from putting_dune_torch.env import features as t_features
from putting_dune_torch.image_alignment import train as t_align_train
from putting_dune_torch.parallel import mesh as t_mesh
from putting_dune_torch.rate_learning import model as t_model
from putting_dune_tpu.atom_detection import train as j_det_train
from putting_dune_tpu.env import features as j_features
from putting_dune_tpu.image_alignment import train as j_align_train
from putting_dune_tpu.rate_learning import model as j_model

WORKER = pathlib.Path(__file__).resolve().parent / 'torch_dist_worker.py'
REPO = WORKER.parent.parent


@pytest.mark.parametrize('t_train,j_train', [
    (t_det_train, j_det_train), (t_align_train, j_align_train)],
    ids=['detector', 'aligner'])
def test_load_arch_reads_what_the_jax_package_reads(tmp_path, t_train,
                                                    j_train):
  assert t_train.load_arch(str(tmp_path)) is None
  assert j_train.load_arch(str(tmp_path)) is None
  arch = {'features': [8, 16], 'image_size': 32, 'num_frames': 3}
  (tmp_path / 'arch.json').write_text(json.dumps(arch))
  assert t_train.load_arch(str(tmp_path)) == j_train.load_arch(
      str(tmp_path)) == arch


def test_features_alias_is_an_array_or_a_dict_of_arrays():
  for alias, array in ((t_features.Features, torch.Tensor),
                       (j_features.Features, None)):
    assert typing.get_origin(alias) is typing.Union
    single, mapping = typing.get_args(alias)
    assert typing.get_origin(mapping) is dict
    key, value = typing.get_args(mapping)
    assert key is str and value is single
    if array is not None:
      assert single is array


def test_rate_model_aliases_equal_the_jax_packages():
  assert t_model.Params is j_model.Params is dict
  assert t_model.State is j_model.State is dict
  for alias in (t_model.ApplyFn, j_model.ApplyFn):
    assert typing.get_origin(alias) is collections.abc.Callable
    _, returned = typing.get_args(alias)
    assert typing.get_origin(returned) is tuple
    assert typing.get_args(returned)[1] is dict


def test_global_batch_multihost_at_one_rank_is_shard_batch():
  mesh = t_mesh.make_mesh(device='cpu')
  batch = {'x': torch.arange(12.0).reshape(4, 3), 'rows': np.arange(4),
           'odd': np.arange(3), 'scalar': torch.tensor(1.5), 'name': 'b'}
  sharded = t_mesh.shard_batch(batch, mesh)
  out = t_mesh.global_batch_multihost(sharded, mesh)
  for key in ('x', 'scalar'):
    assert torch.equal(out[key], batch[key])
    assert torch.equal(sharded[key], batch[key])
  for key in ('rows', 'odd'):
    np.testing.assert_array_equal(out[key], batch[key])
  assert out['name'] == 'b'


def test_global_batch_multihost_on_two_ranks_rebuilds_the_batch(tmp_path):
  port = t_mesh.free_port()
  env = dict(os.environ, PYTHONPATH=str(REPO))
  procs = [subprocess.Popen(
      [sys.executable, str(WORKER), 'batch', str(rank), '2', str(port),
       str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True, env=env) for rank in range(2)]
  try:
    outputs = [p.communicate(timeout=60)[0] for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, out in zip(procs, outputs):
    assert p.returncode == 0, out[-3000:]
  full_x = np.arange(24, dtype=np.float32).reshape(8, 3)
  for rank in range(2):
    got = np.load(tmp_path / f'rank{rank}.npz')
    np.testing.assert_array_equal(got['local_x'],
                                  full_x[4 * rank:4 * rank + 4])
    np.testing.assert_array_equal(got['x'], full_x)
    np.testing.assert_array_equal(got['rows'], np.arange(8) * 10)
    # The JAX rule: 5 rows times 2 ranks divide the axis, so the ranks'
    # (replicated) copies are gathered like blocks.
    np.testing.assert_array_equal(got['odd'], np.tile(np.arange(5), 2))
    assert float(got['scalar']) == 2.5


SUBPACKAGES = ('agents', 'alignment', 'atom_detection', 'env',
               'graph_alignment', 'image_alignment', 'imaging', 'parallel',
               'experiments')


def _reexports(sub):
  """{name: the JAX submodule it comes from} of a JAX subpackage's
  `__init__.py` (`from putting_dune_tpu.<sub>.<module> import ...`)."""
  path = REPO / 'putting_dune_tpu' / sub / '__init__.py'
  out = {}
  for node in ast.parse(path.read_text()).body:
    if isinstance(node, ast.ImportFrom):
      for alias in node.names:
        source = f'{node.module}.{alias.name}' if alias.name == 'registry' \
            else node.module
        out[alias.asname or alias.name] = source
  return out


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_subpackages_reexport_the_jax_packages_names(sub):
  jax_package = importlib.import_module(f'putting_dune_tpu.{sub}')
  port_package = importlib.import_module(f'putting_dune_torch.{sub}')
  assert list(port_package.__all__) == list(jax_package.__all__)
  sources = _reexports(sub)
  assert sorted(sources) == sorted(jax_package.__all__)
  for name, source in sources.items():
    port_module = importlib.import_module(
        source.replace('putting_dune_tpu', 'putting_dune_torch'))
    want = (port_module if source.endswith('.registry')
            else getattr(port_module, name))
    assert getattr(port_package, name) is want, (sub, name)


def test_experiments_are_the_registry():
  from putting_dune_torch import registry  # pylint: disable=g-import-not-at-top
  from putting_dune_torch.experiments import experiments  # pylint: disable=g-import-not-at-top
  from putting_dune_torch.experiments import registry as exp_registry  # pylint: disable=g-import-not-at-top
  from putting_dune_tpu.experiments import experiments as j_experiments  # pylint: disable=g-import-not-at-top

  assert exp_registry is registry
  for name in ('AdaptersAndGoal', 'SimulatorSpec', 'TrainExperiment',
               'EvalExperiment', 'MicroscopeExperiment', 'AgentConstructor',
               'AdaptersAndGoalConstructor', 'SimulatorSpecConstructor'):
    assert hasattr(j_experiments, name)
    assert getattr(experiments, name) is getattr(registry, name)
  assert 'greedy_simple_rates' in exp_registry.eval_experiment_names()
  for alias, result in (('AgentConstructor', typing.Any),
                        ('AdaptersAndGoalConstructor',
                         registry.AdaptersAndGoal),
                        ('SimulatorSpecConstructor', registry.SimulatorSpec)):
    port, jax_alias = getattr(registry, alias), getattr(j_experiments, alias)
    assert typing.get_origin(port) is typing.get_origin(jax_alias)
    assert typing.get_args(port)[-1] is result
    assert len(typing.get_args(port)[0]) == len(typing.get_args(jax_alias)[0])


def _port_modules():
  names = []
  for path in sorted((REPO / 'putting_dune_torch').rglob('*.py')):
    parts = list(path.relative_to(REPO).with_suffix('').parts)
    if parts[-1] == '__init__':
      parts = parts[:-1]
    names.append('.'.join(parts))
  return names


_IMPORT_EACH = """
import importlib, os, sys
for name in sys.argv[1:]:
  pid = os.fork()
  if pid == 0:
    try:
      importlib.import_module(name)
    except BaseException as e:
      print(f'{name}: {type(e).__name__}: {e}', flush=True)
      os._exit(1)
    os._exit(0)
  _, status = os.waitpid(pid, 0)
  if status:
    sys.exit(f'{name} does not import alone')
"""


def test_every_port_module_imports_alone():
  """Each module in a fresh interpreter of its own: one process imports
  the third-party packages (torch, numpy, scipy's), then forks a child a
  module, so no module of the port is loaded before the one tested."""
  modules = _port_modules()
  code = ('import numpy, scipy.ndimage, scipy.optimize, scipy.spatial, '
          'scipy.stats, torch, torch._decomp\n' + _IMPORT_EACH)
  env = dict(os.environ, PYTHONPATH=str(REPO))
  done = subprocess.run([sys.executable, '-c', code, *modules], env=env,
                        capture_output=True, text=True, timeout=600,
                        cwd=str(REPO))
  assert done.returncode == 0, done.stdout + done.stderr
