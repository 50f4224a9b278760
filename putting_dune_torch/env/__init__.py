"""Batched RL environment (dm_env-compatible at the single-env boundary)."""

from putting_dune_torch.env.env import EnvConfig, PuttingDuneEnv, TimeStep

__all__ = ['EnvConfig', 'PuttingDuneEnv', 'TimeStep']
