"""Optimisers and schedules (``repro.optim`` counterpart).  The schedules
are ported; ``sgd`` and ``adamw`` come with the launch path (ROADMAP A13,
A15)."""
from repro_torch.optim.schedules import (constant, cosine, lambda_increase,
                                         step_decay)

__all__ = ["constant", "cosine", "lambda_increase", "step_decay"]
