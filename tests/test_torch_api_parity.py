"""The JAX package's members and keywords, held in the port.

`putting_dune_tpu/**/*.py` is read with `ast` (nothing of it is imported
for the walk). Each file's counterpart is the port module of the same
relative path, imported; `FILE_EXCEPTIONS` lists the files that have
none. For every public top-level function, every public method,
property, classmethod and staticmethod of a public class, and `__init__`
(written, or made by a dataclass, a flax module or a NamedTuple from its
fields), the walk asserts that

  * the member exists in the port;
  * every JAX parameter name is a parameter of the port's counterpart;
  * the positional parameters both packages share come in JAX's order,
    and are positional in the port too;
  * a default that JAX gives is the port's default too, compared as
    source text with the `jnp.` / `np.` / `torch.` prefixes dropped.

The port's side is read from its source (`inspect.getsource`), so that
defaults compare as written. Every exception is one row of `IDIOMS`:
(JAX file, member, JAX names, port names, reason). A row takes its JAX
names out of all four checks and requires its port names among the
port's parameters; its reason is one of the PyTorch idioms below or a
"Recorded differences" entry of ROADMAP.md. The row test fails for a
row whose member would pass without it.

Below the walk, each of the gaps it found is held to the JAX function:
the results' `seconds_to_goal` properties, `evaluate_batched`'s
`max_steps` and `chunk_steps`, `grid_columns` in the env factories,
`EvalAgent.params` / `save` / `from_actor_critic`,
`generate_synthetic_data`'s `data_seed`, the UNets' `activation`,
`PolicyCheckpointAgent.weights_dir` and the states' `drift=None`; and the
loop that stops one step after the last episode inside a chunk.
"""

import ast
import dataclasses
import importlib
import inspect
import json
import math
import pathlib
import re
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch import simulator as t_sim
from putting_dune_torch import structures as t_struct
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.atom_detection import model as t_det_model
from putting_dune_torch.env import multi_dopant as t_multi
from putting_dune_torch.image_alignment import model as t_align_model
from putting_dune_torch.rate_learning import data_utils as t_data
from putting_dune_tpu import eval as j_eval_cli
from putting_dune_tpu import eval_lib as j_eval_lib
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import run_helpers as j_run_helpers
from putting_dune_tpu.agents import eval_agent as j_eval_agent
from putting_dune_tpu.atom_detection import model as j_det_model
from putting_dune_tpu.experiments import registry as j_registry
from putting_dune_tpu.image_alignment import model as j_align_model
from putting_dune_tpu.rate_learning import data_utils as j_data

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PACKAGE = REPO / 'putting_dune_tpu'
WEIGHTS = JAX_PACKAGE / 'experiments' / 'model_weights'

# JAX files without a port file of the same path (ROADMAP.md queue 1).
FILE_EXCEPTIONS = {
    'ops/clahe_fused_pallas.py': 'Pallas kernels: CUDA kernels in csrc/',
    'ops/clahe_pallas.py': 'Pallas kernels: CUDA kernels in csrc/',
    'ops/noise_fused_pallas.py': 'Pallas kernels: CUDA kernels in csrc/',
    'ops/splat_pallas.py': 'Pallas kernels: CUDA kernels in csrc/',
    'proto/putting_dune_tpu_pb2.py': 'generated protobuf: proto/wire.py',
    'test_utils.py': "the JAX tests' helpers",
}

# The PyTorch idioms.
MODULES = 'functional params / apply_fn / optim replaced by nn.Modules'
KEYS = 'JAX keys replaced by generators and seeds'
MODULES_AND_KEYS = MODULES + '; ' + KEYS
DEVICES = 'devices replaced by device (a mesh holds its device)'
PERCEPTION_MESH = ("the perception trainers' create_state(mesh) replaced "
                   'by train(mesh=)')
# ROADMAP.md "Recorded differences" entries.
EXPERIMENT_SPLIT = ('ROADMAP recorded difference: EvalExperiment builds the '
                    'batched policy by get_policy, the host agent by '
                    'get_agent')
OWN_DEFAULTS = ("ROADMAP recorded difference: defaults that name each "
                "package's own function or route")

IDIOMS = (
    # (JAX file, member, JAX names, port names, reason)
    ('agents/agent_lib.py', 'uniform_random_policy', ('key',), ('gen',),
     KEYS),
    ('agents/agent_lib.py', 'greedy_policy', ('key',), ('gen',), KEYS),
    ('agents/drift_correction.py', 'DriftCorrectedPolicy.step', ('key',),
     ('gen',), KEYS),
    ('agents/drift_correction.py', 'DriftCorrectedVisionPlannerPolicy.step',
     ('key',), ('gen',), KEYS),
    ('agents/drift_correction.py',
     'DriftCorrectedMultiDopantVisionPlannerPolicy.step', ('key',),
     ('gen',), KEYS),
    ('agents/eval_agent.py', 'EvalAgent.__init__', ('module', 'params'),
     ('model',), MODULES),
    ('agents/planner.py', 'planner_policy', ('key',), ('gen',), KEYS),
    ('agents/planner.py', 'multi_dopant_planner_policy', ('key',),
     ('gen',), KEYS),
    ('agents/ppo.py', 'dryrun_mesh_training_step', ('devices',), ('mesh',),
     DEVICES),
    ('agents/ppo.py', 'as_eval_agent', ('params',), ('model',), MODULES),
    ('agents/vision_planner.py', 'vision_planner_policy', ('key',),
     ('gen',), KEYS),
    ('agents/vision_planner.py', 'multi_dopant_vision_planner_policy',
     ('key',), ('gen',), KEYS),
    ('atom_detection/data.py', 'sample_batch', ('key',), ('gen',), KEYS),
    ('atom_detection/model.py', 'UNet.__init__', ('activation',),
     ('activation',), OWN_DEFAULTS),
    ('atom_detection/train.py', 'create_state', ('mesh',), (),
     PERCEPTION_MESH),
    ('env/action_adapters.py', 'DirectActionAdapter.init_state', ('key',),
     ('gen',), KEYS),
    ('env/action_adapters.py', 'DeltaPositionActionAdapter.init_state',
     ('key',), ('gen',), KEYS),
    ('env/action_adapters.py', 'RelativeToSiliconActionAdapter.init_state',
     ('key',), ('gen',), KEYS),
    ('env/env.py', 'PuttingDuneEnv.reset', ('key',), ('gen',), KEYS),
    ('env/env.py', 'PuttingDuneEnv.step', ('key',), ('gen',), KEYS),
    ('env/goals.py', 'sample_goal', ('key',), ('gen',), KEYS),
    ('env/multi_dopant.py', 'MultiDopantEnv.reset', ('key',), ('gen',),
     KEYS),
    ('env/multi_dopant.py', 'MultiDopantEnv.step', ('key',), ('gen',),
     KEYS),
    ('eval_lib.py', 'StatefulPolicy.step', ('key',), ('gen',), KEYS),
    ('experiments/experiments.py', 'EvalExperiment.__init__',
     ('get_agent',), ('get_policy',), EXPERIMENT_SPLIT),
    ('graph_alignment/data.py', 'sample_batch', ('key',), ('gen',), KEYS),
    ('graph_alignment/model.py', 'batched_apply', ('module', 'params'),
     ('model',), MODULES),
    ('graph_alignment/train.py', 'create_state', ('mesh',), (),
     PERCEPTION_MESH),
    ('image_alignment/data.py', 'sample_stack', ('key',), ('gen',), KEYS),
    ('image_alignment/model.py', 'GlobalLocalUNet.__init__',
     ('activation',), ('activation',), OWN_DEFAULTS),
    ('image_alignment/train.py', 'create_state', ('mesh',), (),
     PERCEPTION_MESH),
    ('imaging/noise.py', 'apply_poisson_noise', ('key',), ('gen',), KEYS),
    ('imaging/noise.py', 'apply_jitter', ('key',), ('gen',), KEYS),
    ('imaging/noise.py', 'apply_salt_and_pepper', ('key',), ('gen',), KEYS),
    ('imaging/noise.py', 'apply_uniform_noise', ('key',), ('gen',), KEYS),
    ('imaging/noise.py', 'apply_exponential_noise', ('key',), ('gen',),
     KEYS),
    ('imaging/noise.py', 'apply_gaussian_noise', ('key',), ('gen',), KEYS),
    ('imaging/params.py', 'sample_imaging_params', ('key',), ('gen',),
     KEYS),
    ('imaging/render.py', 'render_stem_image', ('key',), ('gen',), KEYS),
    ('imaging/render.py', 'render_stem_image', ('noise_backend',),
     ('noise_backend',), OWN_DEFAULTS),
    ('kmc.py', 'apply_control', ('key',), ('gen',), KEYS),
    ('kmc.py', 'apply_control_multi', ('key',), ('gen',), KEYS),
    ('parallel/mesh.py', 'make_mesh', ('devices',), ('device',), DEVICES),
    ('rate_learning/distill.py', 'distill_loss',
     ('params', 'network_state', 'ensemble_params', 'ensemble_state', 'key',
      'apply_fn'), ('student', 'teacher', 'generator'), MODULES_AND_KEYS),
    ('rate_learning/distill.py', 'distill_train_epoch',
     ('params', 'network_state', 'ensemble_params', 'ensemble_state',
      'opt_state', 'key', 'optim', 'apply_fn'),
     ('student', 'teacher', 'optimizer', 'generator'), MODULES_AND_KEYS),
    ('rate_learning/distill.py', 'distill_multiple_models_to_single',
     ('key', 'optim', 'apply_fn', 'init_fn', 'ensemble_params',
      'ensemble_state'), ('generator', 'teacher'), MODULES_AND_KEYS),
    ('rate_learning/losses.py', 'batched_loss_fn',
     ('params', 'network_state', 'apply_fn', 'key'), ('model',),
     MODULES_AND_KEYS),
    ('rate_learning/predictor.py', 'LearnedRatePredictor.__init__',
     ('init_key',), ('generator', 'seed'), KEYS),
    ('rate_learning/predictor.py', 'LearnedRatePredictor.apply_model',
     ('key',), (), KEYS),
    ('rate_learning/predictor.py', 'LearnedRatePredictor.train', ('key',),
     (), KEYS),
    ('rate_learning/train.py', 'train_epoch',
     ('params', 'network_state', 'opt_state', 'optim', 'apply_fn', 'key'),
     ('model', 'optimizer', 'generator'), MODULES_AND_KEYS),
    ('rate_learning/train.py', 'train_model',
     ('key', 'params', 'network_state', 'opt_state', 'apply_fn', 'optim'),
     ('model', 'optimizer', 'generator'), MODULES_AND_KEYS),
    ('rate_learning/train.py', 'train_multiple_models',
     ('key', 'optim', 'apply_fn', 'init_fn'), ('generator',),
     MODULES_AND_KEYS),
    ('rate_learning/train.py', 'dryrun_ensemble_training_step',
     ('devices',), ('mesh',), DEVICES),
    ('simulator.py', 'reset', ('key',), ('gen',), KEYS),
    ('simulator.py', 'step', ('key',), ('gen',), KEYS),
)

REASONS = (MODULES, KEYS, MODULES_AND_KEYS, DEVICES, PERCEPTION_MESH,
           EXPERIMENT_SPLIT, OWN_DEFAULTS)


# -- reading signatures -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
  name: str
  positional: bool
  default: object  # source text, or None where there is no default


def _params_of(fn: ast.FunctionDef, drop_first: bool) -> list:
  args = fn.args
  positional = args.posonlyargs + args.args
  defaults = ([None] * (len(positional) - len(args.defaults))
              + list(args.defaults))
  out = [Param(a.arg, True, d and ast.unparse(d))
         for a, d in zip(positional, defaults)]
  if args.vararg:
    out.append(Param('*' + args.vararg.arg, False, None))
  out += [Param(a.arg, False, d and ast.unparse(d))
          for a, d in zip(args.kwonlyargs, args.kw_defaults)]
  if args.kwarg:
    out.append(Param('**' + args.kwarg.arg, False, None))
  return out[1:] if drop_first else out


def _field_default(value):
  if value is None:
    return None
  if (isinstance(value, ast.Call)
      and ast.unparse(value.func).split('.')[-1] == 'field'):
    for keyword in value.keywords:
      if keyword.arg == 'default':
        return ast.unparse(keyword.value)
      if keyword.arg == 'default_factory':
        return 'factory ' + ast.unparse(keyword.value)
    return None
  return ast.unparse(value)


def _fields_of(cls: ast.ClassDef) -> list:
  return [Param(node.target.id, True, _field_default(node.value))
          for node in cls.body
          if isinstance(node, ast.AnnAssign)
          and isinstance(node.target, ast.Name)
          and 'ClassVar' not in ast.unparse(node.annotation)]


def _has_fields(cls: ast.ClassDef) -> bool:
  """A dataclass, a flax module or struct, or a NamedTuple."""
  if any('dataclass' in ast.unparse(d) for d in cls.decorator_list):
    return True
  return any(ast.unparse(b) in ('nn.Module', 'NamedTuple', 'typing.NamedTuple',
                                'struct.PyTreeNode') for b in cls.bases)


def _kind(fn: ast.FunctionDef) -> str:
  decorators = [ast.unparse(d) for d in fn.decorator_list]
  for kind in ('property', 'classmethod', 'staticmethod'):
    if kind in decorators:
      return kind
  return 'method'


def jax_members(rel: str) -> dict:
  """{member: (kind, params or None)} of one JAX file, read with ast."""
  tree = ast.parse((JAX_PACKAGE / rel).read_text())
  classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
  out = {}
  for node in tree.body:
    if (not isinstance(node, (ast.FunctionDef, ast.ClassDef))
        or node.name.startswith('_')):
      continue
    if isinstance(node, ast.FunctionDef):
      out[node.name] = ('function', _params_of(node, False))
    elif isinstance(node, ast.ClassDef):
      out[node.name] = ('class', None)
      if any(ast.unparse(b).endswith('Enum') for b in node.bases):
        continue
      for fn in node.body:
        if not isinstance(fn, ast.FunctionDef):
          continue
        if fn.name == '__init__' or not fn.name.startswith('_'):
          kind = _kind(fn)
          out[f'{node.name}.{fn.name}'] = (
              kind, None if kind == 'property'
              else _params_of(fn, kind != 'staticmethod'))
      if f'{node.name}.__init__' not in out and _has_fields(node):
        fields = []
        for base in node.bases:
          if ast.unparse(base) in classes:
            fields += _fields_of(classes[ast.unparse(base)])
        out[f'{node.name}.__init__'] = ('fields',
                                        fields + _fields_of(node))
  return out


def _source_params(fn, drop_first: bool) -> list:
  node = ast.parse(textwrap.dedent(inspect.getsource(
      inspect.unwrap(fn)))).body[0]
  assert isinstance(node, ast.FunctionDef), fn
  return _params_of(node, drop_first)


def _port_init(cls) -> list:
  """The port class's constructor parameters: its (inherited) `__init__`
  from source, or its dataclass or NamedTuple fields from the source of
  each class."""
  if issubclass(cls, tuple) and hasattr(cls, '_fields'):
    node = ast.parse(textwrap.dedent(inspect.getsource(cls))).body[0]
    return _fields_of(node)
  if dataclasses.is_dataclass(cls):
    by_name = {}
    for klass in reversed(cls.__mro__):
      if dataclasses.is_dataclass(klass):
        node = ast.parse(textwrap.dedent(inspect.getsource(klass))).body[0]
        by_name.update((p.name, p) for p in _fields_of(node))
    return [by_name[f.name] for f in dataclasses.fields(cls) if f.init]
  for klass in cls.__mro__:
    if '__init__' in vars(klass):
      return _source_params(vars(klass)['__init__'], True)
  raise AssertionError(f'{cls} has no __init__')


def port_member(module, member: str):
  """(kind, params or None) of the port's counterpart, or None where the
  port has no such member."""
  owner_name, _, name = member.rpartition('.')
  if not owner_name:
    obj = getattr(module, name, None)
    if obj is None:
      return None
    if inspect.isclass(obj):
      return ('class', None)
    return ('function', _source_params(obj, False))
  owner = getattr(module, owner_name, None)
  if owner is None:
    return None
  if name == '__init__':
    return ('method', _port_init(owner))
  for klass in owner.__mro__:
    if name in vars(klass):
      attr = vars(klass)[name]
      if isinstance(attr, property):
        return ('property', None)
      if isinstance(attr, (classmethod, staticmethod)):
        return (type(attr).__name__,
                _source_params(attr.__func__,
                               isinstance(attr, classmethod)))
      return ('method', _source_params(attr, True))
  return None


def _normal(default: str) -> str:
  return re.sub(r'\b(jax\.numpy|jnp|numpy|np|torch)\.', '', default)


def member_faults(jax_kind, jax_params, port, rows) -> list:
  """What the port's counterpart breaks of the JAX member, after the
  rows' JAX names are taken out of the checks."""
  if port is None:
    return ['missing in the port']
  port_kind, port_params = port
  if jax_kind == 'property':
    return [] if port_kind == 'property' else [f'a {port_kind}, not a '
                                               'property']
  if jax_kind == 'class':
    return [] if port_kind == 'class' else ['not a class']
  faults = []
  excused = {n for row in rows for n in row[2]}
  port_names = {p.name for p in port_params}
  for row in rows:
    absent = [n for n in row[3] if n not in port_names]
    if absent:
      faults.append(f'row names {absent}, which the port does not take')
  checked = [p for p in jax_params if p.name not in excused]
  missing = [p.name for p in checked if p.name not in port_names]
  if missing:
    faults.append(f'does not take {missing}')
  shared = [p.name for p in checked if p.positional and p.name in port_names]
  port_order = [p.name for p in port_params
                if p.positional and p.name in shared]
  if port_order != shared:
    faults.append(f'positional order {port_order}, JAX {shared}')
  port_defaults = {p.name: p.default for p in port_params}
  for p in checked:
    if p.default is None or p.name not in port_names:
      continue
    other = port_defaults[p.name]
    if other is None or _normal(other) != _normal(p.default):
      faults.append(f'default of {p.name}: {other}, JAX {p.default}')
  return faults


def jax_files() -> list:
  return sorted(p.relative_to(JAX_PACKAGE).as_posix()
                for p in JAX_PACKAGE.rglob('*.py'))


def port_module(rel: str):
  name = 'putting_dune_torch.' + rel[:-len('.py')].replace('/', '.')
  return importlib.import_module(name.removesuffix('.__init__'))


def module_faults(rel: str, rows=IDIOMS) -> dict:
  module = port_module(rel)
  faults = {}
  for member, (kind, params) in jax_members(rel).items():
    mine = [r for r in rows if r[0] == rel and r[1] == member]
    found = member_faults(kind, params, port_member(module, member), mine)
    if found:
      faults[member] = found
  return faults


# -- the walk -----------------------------------------------------------------


@pytest.mark.parametrize(
    'rel', [f for f in jax_files() if f not in FILE_EXCEPTIONS])
def test_port_keeps_the_jax_members_and_keywords(rel):
  assert module_faults(rel) == {}


def test_file_exceptions_are_files_without_a_port_file():
  files = jax_files()
  for rel in FILE_EXCEPTIONS:
    assert rel in files, rel
    assert not (REPO / 'putting_dune_torch' / rel).exists(), rel


def test_every_idiom_row_is_needed():
  """Each row names a member the walk reads, a reason from the list, JAX
  names that the JAX member takes, and, taken out, makes its member
  fail."""
  assert len(set(IDIOMS)) == len(IDIOMS)
  for row in IDIOMS:
    rel, member, jax_names, _, reason = row
    assert reason in REASONS, row
    kind, params = jax_members(rel)[member]
    assert kind not in ('class', 'property'), row
    assert set(jax_names) <= {p.name for p in params}, row
    rest = tuple(r for r in IDIOMS if r != row)
    assert member in module_faults(rel, rest), f'row not needed: {row}'


# -- the results' properties --------------------------------------------------


def _results(module):
  rows = [(0, True, 7, 1.25, 40.5, 0.5), (1, False, 30, float('nan'),
                                            float('nan'), -1.0),
          (2, True, 9, 2.0, 61.25, 0.75)]
  fields = ('seed', 'reached_goal', 'num_actions_taken',
            'agent_seconds_to_goal', 'environment_seconds_to_goal',
            'total_reward')
  return [module.EvalResult(**dict(zip(fields, r)), evaluator='e')
          for r in rows]


def test_seconds_to_goal_properties_equal_the_jax_packages():
  port, jax_results = _results(t_eval_lib), _results(j_eval_lib)
  for t, j in zip(port, jax_results):
    assert (t.seconds_to_goal == j.seconds_to_goal
            or math.isnan(t.seconds_to_goal) and math.isnan(j.seconds_to_goal))
  assert port[0].seconds_to_goal == 41.75
  t_agg = t_eval_lib.aggregate_results(port)
  j_agg = j_eval_lib.aggregate_results(jax_results)
  assert t_agg.average_seconds_to_goal == j_agg.average_seconds_to_goal
  assert t_agg.average_seconds_to_goal == (1.25 + 40.5 + 2.0 + 61.25) / 2


# -- evaluate_batched: max_steps and chunk_steps ------------------------------


def _jax_eval(name, seeds, **kwargs):
  exp = j_registry.create_eval_experiment(name)
  agent = exp.get_agent(np.random.default_rng(0), exp.get_adapters_and_goal())
  env = j_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(seeds), grid_columns=kwargs.pop('grid_columns', 50))
  return j_eval_lib.evaluate_batched(
      env, j_eval_cli._policy_for_agent(agent, env), seeds, **kwargs)


def _port_eval(name, seeds, grid_columns=50, **kwargs):
  exp = t_registry.create_eval_experiment(name)
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(seeds), grid_columns=grid_columns, device='cpu')
  agent = exp.get_policy(exp.get_adapters_and_goal(), 'cpu')
  policy = agent.policy() if hasattr(agent, 'policy') else agent
  return t_eval_lib.evaluate_batched(env, policy, seeds, **kwargs)


def test_max_steps_caps_the_episodes_as_in_the_jax_package():
  seeds, cap = tuple(range(24)), 5
  for results in (_jax_eval('relative_random_simple', seeds, max_steps=cap),
                  _port_eval('relative_random_simple', seeds,
                             max_steps=cap)):
    missed = [r for r in results if not r.reached_goal]
    assert len(missed) >= len(seeds) // 2
    assert all(r.num_actions_taken == cap for r in missed)
    assert all(math.isnan(r.environment_seconds_to_goal) for r in missed)
    assert all(r.num_actions_taken <= cap for r in results)


def _same(a, b) -> bool:
  def key(r):
    return tuple('nan' if isinstance(v, float) and math.isnan(v) else v
                 for v in dataclasses.astuple(r))
  return [key(r) for r in a] == [key(r) for r in b]


@pytest.mark.parametrize('chunk_steps', [1, 7])
def test_chunk_steps_do_not_change_the_results(monkeypatch, chunk_steps):
  # The wall clock is held still, so only simulated seconds count against
  # the budget and the two runs see the same truncations.
  monkeypatch.setattr(t_eval_lib.time, 'perf_counter', lambda: 0.0)
  seeds = tuple(range(12))
  whole = _port_eval('greedy_simple_rates', seeds)
  assert sum(r.reached_goal for r in whole) >= 10
  assert _same(whole, _port_eval('greedy_simple_rates', seeds,
                                 chunk_steps=chunk_steps))
  capped = _port_eval('relative_random_simple', seeds, max_steps=40)
  assert _same(capped, _port_eval('relative_random_simple', seeds,
                                  max_steps=40, chunk_steps=chunk_steps))


def test_the_loop_stops_one_step_after_the_last_episode():
  # Inside a chunk "all done" is read without a sync, one step late: the
  # loop runs the longest episode's steps and one masked step, not the
  # whole chunk of 64.
  exp = t_registry.create_eval_experiment('greedy_simple_rates')
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=8,
      device='cpu')
  step, calls = env.step, []
  env.step = lambda *args: calls.append(1) or step(*args)
  results = t_eval_lib.evaluate_batched(
      env, exp.get_policy(exp.get_adapters_and_goal(), 'cpu'), range(8))
  longest = max(r.num_actions_taken for r in results)
  assert all(r.reached_goal for r in results) and longest < 63
  assert len(calls) == longest + 1


def test_chunk_steps_below_one_raise():
  with pytest.raises(ValueError, match='chunk_steps'):
    _port_eval('greedy_simple_rates', (0,), chunk_steps=0)


# -- grid_columns -------------------------------------------------------------


def test_grid_columns_reach_the_lattice_and_the_simulator():
  exp = t_registry.create_eval_experiment('greedy_simple_rates')
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=2,
      grid_columns=20, device='cpu')
  single = t_run_helpers.create_putting_dune_env(
      0, exp.get_adapters_and_goal, exp.get_simulator_config,
      grid_columns=20, device='cpu')
  want = j_lattice.make_lattice(20)
  for lattice, config in ((env.lattice, env.config),
                          (single._env.lattice, single._env.config)):  # pylint: disable=protected-access
    assert config.sim.grid_columns == 20
    np.testing.assert_allclose(lattice.positions.numpy(),
                               np.asarray(want.positions), atol=1e-6)
    np.testing.assert_array_equal(lattice.neighbors.numpy(),
                                  np.asarray(want.neighbors))
  assert env.lattice.positions.shape == t_lattice.make_lattice(
      20, 'cpu').positions.shape


def _z(p1, p2, n1, n2):
  p = (p1 * n1 + p2 * n2) / (n1 + n2)
  se = np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
  return (p1 - p2) / se if se > 0 else 0.0


def test_greedy_on_a_20_column_lattice_matches_jax_in_distribution():
  # Both packages on 60 seeds (their streams differ): the success rates
  # and the actions to goal within 3 standard errors.
  seeds = tuple(range(60))
  want = _jax_eval('greedy_simple_rates', seeds, grid_columns=20)
  got = _port_eval('greedy_simple_rates', seeds, grid_columns=20)
  j_ok = np.array([r.reached_goal for r in want])
  t_ok = np.array([r.reached_goal for r in got])
  assert t_ok.mean() >= 0.8
  assert abs(_z(t_ok.mean(), j_ok.mean(), len(seeds), len(seeds))) < 3.0
  j_act = np.array([r.num_actions_taken for r in want])[j_ok]
  t_act = np.array([r.num_actions_taken for r in got])[t_ok]
  se = np.hypot(j_act.std(ddof=1) / np.sqrt(len(j_act)),
                t_act.std(ddof=1) / np.sqrt(len(t_act)))
  assert abs(t_act.mean() - j_act.mean()) / se < 3.0


# -- EvalAgent ----------------------------------------------------------------

SHIPPED = ('ppo_simple_images_tf', '230422_ppo_v3_2s')


def _assert_same_tree(a, b, atol=0.0):
  assert sorted(a) == sorted(b)
  for k in a:
    if isinstance(a[k], dict):
      _assert_same_tree(a[k], b[k], atol)
    else:
      x, y = np.asarray(a[k]), np.asarray(b[k])
      assert x.shape == y.shape, k
      assert np.abs(x - y).max(initial=0.0) <= atol, k


def _observation(params, seed=0, batch=4):
  """A batch of observations the policy takes, made with numpy."""
  rng = np.random.default_rng(seed)
  if 'conv_16' in params:
    return {'image': rng.random((batch, 128, 128, 1), np.float32),
            'goal_delta_angstroms': rng.normal(size=(batch, 2)).astype(
                np.float32)}
  return rng.normal(size=(batch, params['Dense_0']['kernel'].shape[0])
                    ).astype(np.float32)


def _port_actions(agent, obs):
  tensors = ({k: torch.from_numpy(v) for k, v in obs.items()}
             if isinstance(obs, dict) else torch.from_numpy(obs))
  return agent.policy()(None, tensors).numpy()


def _jax_actions(agent, obs):
  return np.asarray(agent.policy()(None, jax.tree_util.tree_map(
      jnp.asarray, obs)))


@pytest.mark.parametrize('name', SHIPPED)
def test_eval_agent_params_equal_the_jax_packages(name):
  want = j_eval_agent.EvalAgent.load(str(WEIGHTS / name)).params
  got = t_eval_agent.EvalAgent.load(str(WEIGHTS / name), 'cpu').params
  _assert_same_tree(got, jax.device_get(want))


@pytest.mark.parametrize('name', SHIPPED)
def test_saved_eval_agent_loads_in_both_packages(tmp_path, name):
  agent = t_eval_agent.EvalAgent.load(str(WEIGHTS / name), 'cpu')
  agent.save(str(tmp_path / 'port'))
  j_eval_agent.EvalAgent.load(str(WEIGHTS / name)).save(
      str(tmp_path / 'jax'))
  for file in ('policy.json', 'policy.ckpt'):
    assert ((tmp_path / 'port' / file).read_bytes()
            == (tmp_path / 'jax' / file).read_bytes()), file
  tmp_path = tmp_path / 'port'
  back = t_eval_agent.EvalAgent.load(str(tmp_path), 'cpu')
  _assert_same_tree(back.params, agent.params)
  jax_agent = j_eval_agent.EvalAgent.load(str(tmp_path))
  obs = _observation(agent.params)
  want = _port_actions(agent, obs)
  np.testing.assert_array_equal(_port_actions(back, obs), want)
  np.testing.assert_allclose(_jax_actions(jax_agent, obs), want, atol=1e-5)


def test_from_actor_critic_acts_as_the_loaded_agent():
  path = WEIGHTS / 'ppo_simple_images_tf'
  arch = json.loads((path / 'policy.json').read_text())['arch']
  agent = t_eval_agent.EvalAgent.load(str(path), 'cpu')
  rebuilt = t_eval_agent.EvalAgent.from_actor_critic(
      agent.params, **arch, device='cpu')
  jax_rebuilt = j_eval_agent.EvalAgent.from_actor_critic(
      j_eval_agent.EvalAgent.load(str(path)).params, **arch)
  obs = _observation(agent.params, seed=1)
  want = _port_actions(agent, obs)
  np.testing.assert_array_equal(_port_actions(rebuilt, obs), want)
  np.testing.assert_allclose(_jax_actions(jax_rebuilt, obs), want,
                             atol=1e-5)
  with pytest.raises(ValueError, match='do not fit'):
    t_eval_agent.EvalAgent.from_actor_critic(
        agent.params, **dict(arch, hidden=[128, 128]), device='cpu')


def test_policy_checkpoint_agent_reads_its_weights_dir(tmp_path):
  agent = t_eval_agent.EvalAgent.load(str(WEIGHTS / '230422_ppo_v3_2s'),
                                      'cpu')
  agent.save(str(tmp_path / 'mine'))
  adapters = t_registry.create_eval_experiment(
      'greedy_simple_rates').get_adapters_and_goal()
  loaded = t_registry.PolicyCheckpointAgent(
      'mine', weights_dir=str(tmp_path))(None, adapters, 'cpu')
  _assert_same_tree(loaded.params, agent.params)
  jax_loaded = j_registry.PolicyCheckpointAgent(
      'mine', weights_dir=str(tmp_path))(None, None)
  _assert_same_tree(jax.device_get(jax_loaded.params), agent.params)
  with pytest.raises(FileNotFoundError):
    t_registry.PolicyCheckpointAgent('absent', str(tmp_path))(
        None, adapters, 'cpu')


# -- generate_synthetic_data --------------------------------------------------


def test_generate_synthetic_data_takes_the_jax_positional_seed():
  train, test = t_data.generate_synthetic_data(100, 5, device='cpu')
  j_train, j_test = j_data.generate_synthetic_data(100, 5)
  for port, jax_set in ((train, j_train), (test, j_test)):
    assert sorted(port) == sorted(jax_set)
    for k in port:
      assert tuple(port[k].shape) == np.asarray(jax_set[k]).shape, k
  unseeded = t_data.generate_synthetic_data(50, device='cpu')
  for same in (t_data.generate_synthetic_data(50, None, device='cpu'),
               t_data.generate_synthetic_data(50, 0, device='cpu'),
               t_data.generate_synthetic_data(
                   50, 5, generator=torch.Generator().manual_seed(0),
                   device='cpu')):
    for a, b in zip(unseeded, same):
      for k in a:
        assert torch.equal(a[k], b[k]), k
  assert not torch.equal(train['position'][:50], unseeded[0]['position'])


# -- the UNets' activation ----------------------------------------------------


def test_unet_activation_is_applied_as_in_the_jax_package():
  features = (4, 8)
  module = j_det_model.UNet(features=features, activation=nn.relu)
  x = np.random.default_rng(0).random((2, 16, 16, 1), np.float32)
  params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
  want = np.asarray(module.apply({'params': params}, jnp.asarray(x)))
  net = t_det_model.UNet(features=features, activation=torch.relu)
  net.load_state_dict(t_det_model.params_from_flax(jax.device_get(params)))
  with torch.no_grad():
    got = net(torch.from_numpy(x)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-4)
  gelu = t_det_model.UNet(features=features)
  gelu.load_state_dict(net.state_dict())
  with torch.no_grad():
    assert not np.allclose(gelu(torch.from_numpy(x)).numpy(), got)


def test_global_local_unet_activation_is_applied_as_in_the_jax_package():
  features = (4, 8)
  module = j_align_model.GlobalLocalUNet(
      local_output_size=6, features=features, activation=nn.relu)
  x = np.random.default_rng(1).random((2, 16, 16, 2), np.float32)
  params = module.init(jax.random.PRNGKey(1), jnp.asarray(x))['params']
  want = module.apply({'params': params}, jnp.asarray(x))
  net = t_align_model.GlobalLocalUNet(
      local_output_size=6, features=features, in_channels=2,
      activation=torch.relu)
  net.load_state_dict(t_align_model.params_from_flax(
      jax.device_get(params)))
  with torch.no_grad():
    got = net(torch.from_numpy(x))
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


# -- states without drift -----------------------------------------------------


def test_states_without_drift_hold_zero_drift():
  state, _ = t_sim.reset(torch.Generator().manual_seed(0),
                         t_lattice.make_lattice(50, 'cpu'), batch_size=3)
  fields = {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state) if f.name != 'drift'}
  rebuilt = t_struct.SimulatorState(**fields)
  assert torch.equal(rebuilt.drift, torch.zeros(3, 2))
  env = t_multi.MultiDopantEnv(
      lattice=t_lattice.make_lattice(50, 'cpu'),
      rate_fn=t_rates.simple_canonical_rates, num_dopants=2, batch_size=3,
      device='cpu')
  md_state, _ = env.reset(torch.Generator().manual_seed(0))
  fields = {f.name: getattr(md_state, f.name)
            for f in dataclasses.fields(md_state) if f.name != 'drift'}
  assert torch.equal(t_multi.MultiDopantState(**fields).drift,
                     torch.zeros(3, 2))
