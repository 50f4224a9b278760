"""Rate learning: survival-likelihood training of neural KMC rate models,
the bootstrap ensemble as one batched program, distillation, and a
predictor that plugs into the planners and the KMC engine (port of
putting_dune_tpu/rate_learning/)."""

from putting_dune_torch.rate_learning.config import (
    DistillConfig,
    RateLearningConfig,
)
from putting_dune_torch.rate_learning.predictor import LearnedRatePredictor

__all__ = ['DistillConfig', 'RateLearningConfig', 'LearnedRatePredictor']
