"""Environment factories (port of putting_dune_tpu/run_helpers.py): the
batched environment, and the single one behind the dm_env surface."""

from __future__ import annotations

from typing import Optional

from putting_dune_torch import device as device_lib
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import simulator as simulator_lib
from putting_dune_torch.env import dm_env_wrapper
from putting_dune_torch.env import env as env_lib


def create_batched_env(
    get_adapters_and_goal,
    get_simulator_config,
    *,
    batch_size: int = 1,
    step_limit: Optional[int] = 600,
    grid_columns: int = 50,
    image_size: Optional[int] = None,
    device=None,
) -> env_lib.PuttingDuneEnv:
  """Builds the batched environment from experiment parts.

  grid_columns sets the lattice's width (SimulatorConfig and make_lattice);
  image_size overrides the rendered frame size (default 512); device
  defaults to CUDA and raises if it is absent unless device='cpu'.
  """
  device = device_lib.resolve_device(device)
  adapters = get_adapters_and_goal()
  sim_spec = get_simulator_config()
  sim_config = simulator_lib.SimulatorConfig(
      grid_columns=grid_columns,
      image_duration_seconds=sim_spec.image_duration_seconds,
      drift_per_frame_angstroms=sim_spec.drift_per_frame_angstroms,
      **({'image_size': image_size} if image_size else {}),
  )
  return env_lib.PuttingDuneEnv(
      lattice=lattice_lib.make_lattice(grid_columns, device),
      rate_fn=sim_spec.rate_fn,
      adapter=adapters.action_adapter,
      features=adapters.feature_constructor,
      config=env_lib.EnvConfig(sim=sim_config, step_limit=step_limit),
      batch_size=batch_size,
      device=device,
  )


def create_putting_dune_env(
    seed: int,
    get_adapters_and_goal,
    get_simulator_config,
    *,
    simulator_step_limit: Optional[int] = 600,
    grid_columns: int = 50,
    image_size: Optional[int] = None,
    device=None,
) -> dm_env_wrapper.DmEnvWrapper:
  """The single environment with the dm_env surface and a step limit, on
  `device` (CUDA unless asked otherwise)."""
  env = create_batched_env(
      get_adapters_and_goal, get_simulator_config, batch_size=1,
      step_limit=simulator_step_limit, grid_columns=grid_columns,
      image_size=image_size, device=device)
  return dm_env_wrapper.DmEnvWrapper(env, seed=seed)
