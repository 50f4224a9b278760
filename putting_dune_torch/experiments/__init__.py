"""Named experiment registry (microscope / train / eval).

The JAX package's module path: the classes and the registry live in
putting_dune_torch/registry.py, which both modules here re-export.
"""

from putting_dune_torch.experiments.experiments import (
    AdaptersAndGoal,
    EvalExperiment,
    MicroscopeExperiment,
    SimulatorSpec,
    TrainExperiment,
)
from putting_dune_torch.experiments import registry

__all__ = [
    'AdaptersAndGoal',
    'EvalExperiment',
    'MicroscopeExperiment',
    'SimulatorSpec',
    'TrainExperiment',
    'registry',
]
