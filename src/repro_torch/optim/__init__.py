"""Optimisers and schedules (``repro.optim`` counterpart)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import (constant, cosine, lambda_increase,
                                         step_decay)
from repro_torch.optim.sgd import (SGDState, apply_updates, sgd_init,
                                   sgd_update)

__all__ = ["AdamWState", "SGDState", "adamw_init", "adamw_update",
           "apply_updates", "constant", "cosine", "lambda_increase",
           "sgd_init", "sgd_update", "step_decay"]
