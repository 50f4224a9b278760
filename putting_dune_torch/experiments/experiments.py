"""Experiment composition dataclasses, from putting_dune_torch/registry.py."""

from putting_dune_torch.registry import (
    AdaptersAndGoal,
    AdaptersAndGoalConstructor,
    AgentConstructor,
    EvalExperiment,
    MicroscopeExperiment,
    SimulatorSpec,
    SimulatorSpecConstructor,
    TrainExperiment,
)

__all__ = [
    'AdaptersAndGoal',
    'AdaptersAndGoalConstructor',
    'AgentConstructor',
    'EvalExperiment',
    'MicroscopeExperiment',
    'SimulatorSpec',
    'SimulatorSpecConstructor',
    'TrainExperiment',
]
