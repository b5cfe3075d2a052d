"""Paper-scale models: logistic regression (convex track) and the MLP
(non-convex track), functional like ``repro.models.simple``:
``loss(params, batch) -> scalar`` over a dict of tensors for ONE client —
the round engine batches clients with ``torch.func.vmap``.  The CNN and the
quadratics wait for a later slice."""
from __future__ import annotations

import torch

from repro_torch.models.model import cross_entropy


# -- logistic regression ----------------------------------------------------

def lr_loss(params: dict, batch: dict) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    return cross_entropy(logits, batch["y"])


def lr_accuracy(params: dict, batch: dict) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    return (logits.argmax(-1) == batch["y"]).float().mean()


# -- MLP ---------------------------------------------------------------------

def mlp_init(generator: torch.Generator, n_features: int, hidden: int,
             n_classes: int) -> dict:
    """He-scaled normal weights drawn from ``generator`` (on its device).
    ``torch.Generator`` cannot reproduce ``jax.random`` streams: parity
    tests hand both packages the same numpy-made parameters instead."""
    dev = generator.device
    return {
        "w1": torch.randn(n_features, hidden, generator=generator,
                          device=dev) * (2.0 / n_features) ** 0.5,
        "b1": torch.zeros(hidden, device=dev),
        "w2": torch.randn(hidden, n_classes, generator=generator,
                          device=dev) * (2.0 / hidden) ** 0.5,
        "b2": torch.zeros(n_classes, device=dev),
    }


def _mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: dict, batch: dict) -> torch.Tensor:
    return cross_entropy(_mlp_logits(params, batch["x"]), batch["y"])


def mlp_accuracy(params: dict, batch: dict) -> torch.Tensor:
    logits = _mlp_logits(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).float().mean()
