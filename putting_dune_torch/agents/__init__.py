"""Agents: batched pure policies + dm_env-style host agents."""

from putting_dune_torch.agents.agent_lib import (
    Agent,
    AgentMode,
    GreedyAgent,
    UniformRandomAgent,
    greedy_policy,
    uniform_random_policy,
)

__all__ = [
    'Agent',
    'AgentMode',
    'GreedyAgent',
    'UniformRandomAgent',
    'greedy_policy',
    'uniform_random_policy',
]
