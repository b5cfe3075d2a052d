"""Losses shared by the port's models (``repro.models.model`` counterpart;
the LM stack waits for a later slice)."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.

    The same exact masked reduction as the reference: logsumexp minus the
    masked sum of the label's logit (adding exact zeros), then the mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    mask = labels[..., None] == torch.arange(v, device=labels.device,
                                             dtype=labels.dtype)
    ll = torch.where(mask, logits, 0.0).sum(dim=-1)
    return (lse - ll).mean()
