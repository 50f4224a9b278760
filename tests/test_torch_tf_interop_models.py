"""The port's SavedModel loader on the JAX package's exports, and TF on the
port's exports, for the shipped models.

For each model the JAX package's export runs here (`export_tf` of the
shipped `rate_predictor`, plain and with a fixed context, and
`tf_export.export_tf_saved_model` of the shipped `230422_ppo_v3_2s` MLP):

  * the port's loader on the JAX export agrees with JAX's own output;
  * the port exports the same weights (carried across by the flax -> torch
    readers) and `tf.saved_model.load` on it agrees with TF on the JAX
    export; the signature keys, input names and output structure are equal.

Tolerances: rtol 1e-5 / atol 1e-6 for the rate predictor, 1e-5 for the
MLP (`torch_tf_checks.check`).

With gradients (`with_gradient=True` in both packages): TF's
`GradientTape` on the port's export, and the port's loader under autograd,
equal torch autograd on the native module within 1e-6; the port's loader
on the JAX package's export equals TF's gradient on it within 1e-6.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

tf = pytest.importorskip('tensorflow')
jax = pytest.importorskip('jax')

import jax.numpy as jnp  # pylint: disable=g-import-not-at-top

from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.io import tf_export as t_tf_export
from putting_dune_torch.rate_learning import config as t_rl_config
from putting_dune_torch.rate_learning import predictor as t_predictor
from putting_dune_tpu.agents import eval_agent as j_eval_agent
from putting_dune_tpu.io import tf_export as j_tf_export
from putting_dune_tpu.rate_learning import config as j_rl_config
from putting_dune_tpu.rate_learning import predictor as j_predictor
from torch_tf_checks import check
from torch_tf_checks import check_gradients

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore::UserWarning',
                                        'ignore::FutureWarning',
                                        'ignore::DeprecationWarning')

WEIGHTS = pathlib.Path(t_eval_agent.MODEL_WEIGHTS_DIR)


def test_shipped_rate_predictor(tmp_path):
  """`export_tf` of the shipped predictor, plain and with a fixed
  context prepended to every row."""
  workdir = str(WEIGHTS / 'rate_predictor')
  # Built with the stored config, so that `load` only resizes the ensemble.
  stored = json.loads((WEIGHTS / 'rate_predictor' / 'config.json').read_text())
  stored.pop('num_models_current')
  stored['hidden_dimensions'] = tuple(stored['hidden_dimensions'])
  jax_pred = j_predictor.LearnedRatePredictor(
      config=j_rl_config.RateLearningConfig(**stored))
  jax_pred.load(workdir)
  port_pred = t_predictor.LearnedRatePredictor(
      config=t_rl_config.RateLearningConfig(beam_units='angstroms'),
      device='cpu')
  port_pred.load(workdir)
  rng = np.random.default_rng(0)
  fixed = np.asarray([0.1, 60.0], np.float32)
  for tag, context in (('plain', None), ('fixed', fixed)):
    jax_pred.export_tf(str(tmp_path / f'jax_{tag}'), fixed_context=context)
    port_pred.export_tf(str(tmp_path / f'port_{tag}'), fixed_context=context)
    x = rng.standard_normal((1, 4 if context is None else 2)).astype(
        np.float32)
    full = x if context is None else np.concatenate([fixed[None], x], -1)
    native = np.asarray(jax_pred.apply_model(jnp.asarray(full)))
    check(tmp_path / f'jax_{tag}', tmp_path / f'port_{tag}', x, native,
           1e-5, 1e-6)


def test_shipped_mlp_policy(tmp_path):
  path = str(WEIGHTS / '230422_ppo_v3_2s')
  agent = j_eval_agent.EvalAgent.load(path)
  module, params = agent._module, agent._params  # pylint: disable=protected-access
  obs_dim = int(np.shape(params['Dense_0']['kernel'])[0])
  j_tf_export.export_tf_saved_model(
      lambda obs: module.apply({'params': params}, obs), (obs_dim,),
      str(tmp_path / 'jax'), input_name='observation')
  port_model = t_eval_agent.load_policy(path, device='cpu')
  t_tf_export.export_tf_saved_model(port_model, (obs_dim,),
                                    str(tmp_path / 'port'),
                                    input_name='observation')
  x = np.random.default_rng(2).standard_normal(obs_dim).astype(np.float32)
  native = np.asarray(module.apply({'params': params}, x))
  check(tmp_path / 'jax', tmp_path / 'port', x, native, 1e-5, 1e-5)


def test_shipped_mlp_policy_with_gradient(tmp_path):
  path = str(WEIGHTS / '230422_ppo_v3_2s')
  agent = j_eval_agent.EvalAgent.load(path)
  module, params = agent._module, agent._params  # pylint: disable=protected-access
  obs_dim = int(np.shape(params['Dense_0']['kernel'])[0])
  j_tf_export.export_tf_saved_model(
      lambda obs: module.apply({'params': params}, obs), (obs_dim,),
      str(tmp_path / 'jax'), input_name='observation', with_gradient=True)
  port_model = t_eval_agent.load_policy(path, device='cpu')
  t_tf_export.export_tf_saved_model(port_model, (obs_dim,),
                                    str(tmp_path / 'port'),
                                    input_name='observation',
                                    with_gradient=True)
  x = np.random.default_rng(6).standard_normal(obs_dim).astype(np.float32)
  check_gradients(tmp_path / 'jax', tmp_path / 'port', port_model, x, 1e-6)


def test_shipped_rate_predictor_with_gradient(tmp_path):
  """The ensemble mean that `export_tf` exports, with its gradient."""
  from putting_dune_tpu.rate_learning import losses as j_losses  # pylint: disable=g-import-not-at-top

  workdir = str(WEIGHTS / 'rate_predictor')
  stored = json.loads((WEIGHTS / 'rate_predictor' / 'config.json').read_text())
  stored.pop('num_models_current')
  stored['hidden_dimensions'] = tuple(stored['hidden_dimensions'])
  jax_pred = j_predictor.LearnedRatePredictor(
      config=j_rl_config.RateLearningConfig(**stored))
  jax_pred.load(workdir)

  def apply_model(context):
    out, _ = jax_pred._batch_apply(  # pylint: disable=protected-access
        jax_pred.params, jax_pred.state, context, jax.random.PRNGKey(0),
        False)
    return j_losses.predicted_rates_to_per_neighbor(out).mean(0)

  j_tf_export.export_tf_saved_model(jax.jit(apply_model), (1, 4),
                                    str(tmp_path / 'jax'),
                                    input_name='beam_position',
                                    with_gradient=True)
  port_pred = t_predictor.LearnedRatePredictor(
      config=t_rl_config.RateLearningConfig(beam_units='angstroms'),
      device='cpu')
  port_pred.load(workdir)
  mean = t_predictor._EnsembleMean(port_pred.model.eval(), None)  # pylint: disable=protected-access
  t_tf_export.export_tf_saved_model(mean, (1, 4), str(tmp_path / 'port'),
                                    input_name='beam_position',
                                    with_gradient=True)
  x = np.random.default_rng(7).standard_normal((1, 4)).astype(np.float32)
  check_gradients(tmp_path / 'jax', tmp_path / 'port', mean, x, 1e-6)
