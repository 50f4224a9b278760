"""A run whose timed path is broken underneath reads `correct` false:
for each fault a batched-eval cell can have. The exchange between chips
is no fault here: every cell runs on one chip."""

import pytest
import torch

from benchmark.tests import bench_tiny


def _unchanged_step(monkeypatch):
  """The env's step hands back the state and timestep it was given."""
  from putting_dune_torch.env import env as env_lib

  reset, last = env_lib.PuttingDuneEnv.reset, {}

  def keep_reset(self, gen):
    last['out'] = reset(self, gen)
    return last['out']

  monkeypatch.setattr(env_lib.PuttingDuneEnv, 'reset', keep_reset)
  monkeypatch.setattr(env_lib.PuttingDuneEnv, 'step',
                      lambda self, state, action, gen: (state, last['out'][1]))


def _kmc_never_moves(monkeypatch):
  """The KMC draws and computes its rates, but the silicon stays put."""
  from putting_dune_torch import kmc

  apply_control = kmc.apply_control

  def stuck(gen, lattice, offset, theta, si_index, *args, **kwargs):
    result = apply_control(gen, lattice, offset, theta, si_index, *args,
                           **kwargs)
    return result._replace(si_index=si_index.to(result.si_index.dtype))

  monkeypatch.setattr(kmc, 'apply_control', stuck)


def _action_ignored(monkeypatch):
  """The env aims the beam at the silicon whatever the action says."""
  from putting_dune_torch.env import action_adapters

  cls = action_adapters.RelativeToSiliconActionAdapter
  to_controls = cls.to_controls
  monkeypatch.setattr(
      cls, 'to_controls',
      lambda self, state, ctx, action: to_controls(
          self, state, ctx, torch.zeros_like(action)))


def _actions_miscounted(monkeypatch):
  """The evaluator reports one action more for every episode."""
  from putting_dune_torch import eval_lib

  result = eval_lib.EvalResult

  def more(**kwargs):
    kwargs['num_actions_taken'] += 1
    return result(**kwargs)

  monkeypatch.setattr(eval_lib, 'EvalResult', more)


ENV_FAULTS = {'kmc_never_moves': _kmc_never_moves,
              'action_ignored': _action_ignored,
              'actions_miscounted': _actions_miscounted}


def _half_batch(cls):
  """`cls.forward` on the first half of the batch, its rows repeated."""
  forward = cls.forward

  def half(self, obs):
    image = obs['image'] if isinstance(obs, dict) else obs
    b, h = image.shape[0], (image.shape[0] + 1) // 2
    part = ({k: v[:h] for k, v in obs.items()} if isinstance(obs, dict)
            else obs[:h])
    out = forward(self, part)
    pick = torch.arange(b) % h
    if isinstance(out, tuple):
      return tuple(o[pick.to(o.device)] for o in out)
    return out[pick.to(out.device)]

  return half


def _altered(fn, index=0, delta=0.01):
  """`fn` whose first output (or the tensor) has frame `index` moved."""

  def altered(*args, **kwargs):
    out = fn(*args, **kwargs)
    first = out[0] if isinstance(out, tuple) else out
    first = first.clone()
    first[index] = first[index] + delta
    return (first,) + tuple(out[1:]) if isinstance(out, tuple) else first

  return altered


def _pixel_fault(name, monkeypatch):
  from putting_dune_torch.agents import ppo
  from putting_dune_torch.imaging import clahe

  if name == 'state_unchanged':
    _unchanged_step(monkeypatch)
  elif name in ENV_FAULTS:
    ENV_FAULTS[name](monkeypatch)
  elif name == 'half_batch':
    monkeypatch.setattr(ppo.ActorCritic, 'forward',
                        _half_batch(ppo.ActorCritic))
  elif name == 'frame_altered':
    monkeypatch.setattr(clahe, 'equalize_adapthist',
                        _altered(clahe.equalize_adapthist))
  elif name == 'action_altered':
    monkeypatch.setattr(ppo.ActorCritic, 'forward',
                        _altered(ppo.ActorCritic.forward, delta=1e-3))


def _vision_fault(name, monkeypatch):
  from putting_dune_torch.agents import vision_planner
  from putting_dune_torch.atom_detection import model

  if name == 'state_unchanged':
    _unchanged_step(monkeypatch)
  elif name in ENV_FAULTS:
    ENV_FAULTS[name](monkeypatch)
  elif name == 'half_batch':
    monkeypatch.setattr(model.UNet, 'forward', _half_batch(model.UNet))
  elif name == 'logits_altered':
    monkeypatch.setattr(model.UNet, 'forward',
                        _altered(model.UNet.forward, delta=0.5))
  elif name == 'action_altered':
    monkeypatch.setattr(vision_planner, '_plan_from_frame',
                        _altered(vision_planner._plan_from_frame, delta=0.3))


def _failed(line) -> set:
  return {name for name, c in line['checks'].items()
          if not c['value'] <= c['limit']}


@pytest.mark.parametrize('fault,fails', [
    ('none', set()),
    ('state_unchanged', {'render_compared', 'rate_rel_gap'}),
    ('kmc_never_moves', {'transition_rows_off'}),
    ('action_ignored', {'beam_gap', 'transition_rows_off'}),
    ('actions_miscounted', {'episodes_off'}),
    ('half_batch', {'action_gap'}),
    ('frame_altered', {'obs_pixels_off'}),
    ('action_altered', {'action_gap'})])
def test_pixel_cell_fault_is_not_correct(tmp_path, monkeypatch, fault, fails):
  root = bench_tiny.make_root(str(tmp_path), max_steps=10)
  _pixel_fault(fault, monkeypatch)
  rc, line, err = bench_tiny.run_json(root, 'pixels-eval-b1024', seed=77)
  assert rc == 0, err
  assert line['correct'] == (not fails), line['checks']
  assert _failed(line) >= fails


@pytest.mark.parametrize('fault,fails', [
    ('none', set()),
    ('state_unchanged', {'render_compared', 'rate_rel_gap'}),
    ('kmc_never_moves', {'transition_rows_off'}),
    ('action_ignored', {'beam_gap', 'transition_rows_off'}),
    ('actions_miscounted', {'episodes_off'}),
    ('half_batch', {'detector_rel_rms'}),
    ('logits_altered', {'detector_rel_rms'}),
    ('action_altered', {'planner_gap'})])
def test_vision_cell_fault_is_not_correct(tmp_path, monkeypatch, fault,
                                          fails):
  root = bench_tiny.make_root(str(tmp_path), max_steps=6)
  _vision_fault(fault, monkeypatch)
  rc, line, err = bench_tiny.run_json(root, 'vision-eval-b100', seed=78)
  assert rc == 0, err
  assert line['correct'] == (not fails), line['checks']
  assert _failed(line) >= fails
