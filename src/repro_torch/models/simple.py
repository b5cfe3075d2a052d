"""Paper-scale models, functional like ``repro.models.simple``:
``loss(params, batch) -> scalar`` over a dict of tensors for ONE client —
the round engine batches clients with ``torch.func.vmap``.

* logistic regression (convex track) and the MLP (non-convex track);
* the paper's 2-layer CNN on 28×28×1 images, its parameter tree in the
  reference's shapes (HWIO kernels, NHWC images), so weights cross as
  they are and the flat layout is the same;
* client quadratics with a closed-form optimum (Theorem 1 / 3 checks).

``*_init`` draw from a ``torch.Generator`` on its device; it cannot
reproduce ``jax.random`` streams, so parity tests hand both packages the
same numpy-made parameters instead."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.model import cross_entropy


def _fraction_correct(correct: torch.Tensor) -> torch.Tensor:
    """The mean of a 0/1 vector as ``jnp.mean`` rounds it: one exact
    float32 sum of at most 2²⁴ ones, times float32 1/n (``sum / n`` is
    another rounding, one ulp off at about half of the counts)."""
    inv_n = torch.tensor(1.0 / correct.numel(), dtype=torch.float32,
                         device=correct.device)
    return correct.sum(dtype=torch.float32) * inv_n


# -- logistic regression ----------------------------------------------------

def lr_init(generator: torch.Generator, n_features: int, n_classes: int
            ) -> dict:
    """Zero weights on the generator's device (nothing is drawn)."""
    dev = generator.device
    return {"w": torch.zeros(n_features, n_classes, device=dev),
            "b": torch.zeros(n_classes, device=dev)}


def lr_loss(params: dict, batch: dict) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    return cross_entropy(logits, batch["y"])


def lr_accuracy(params: dict, batch: dict) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    return _fraction_correct(logits.argmax(-1) == batch["y"])


# -- MLP ---------------------------------------------------------------------

def mlp_init(generator: torch.Generator, n_features: int, hidden: int,
             n_classes: int) -> dict:
    """He-scaled normal weights drawn from ``generator`` (on its device)."""
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
    return _fraction_correct(logits.argmax(-1) == batch["y"])


# -- 2-layer CNN (paper Table 3, adapted to 28x28x1 synthetic images) ---------

def cnn_init(generator: torch.Generator, n_classes: int = 10) -> dict:
    """Kernels ``c1 (5, 5, 1, 10)`` and ``c2 (5, 5, 10, 20)`` in HWIO, then
    320 → 50 → ``n_classes``, drawn from ``generator`` (on its device)."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    return {
        "c1": normal(5, 5, 1, 10) * 0.1,
        "c2": normal(5, 5, 10, 20) * 0.1,
        "w1": normal(320, 50) * (2.0 / 320) ** 0.5,
        "b1": torch.zeros(50, device=dev),
        "w2": normal(50, n_classes) * (2.0 / 50) ** 0.5,
        "b2": torch.zeros(n_classes, device=dev),
    }


def _cnn_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, 28, 28, 1) NHWC.  The convolutions run NCHW / OIHW
    (``F.conv2d``, VALID), and the pooled (B, 20, 4, 4) map is put back in
    NHWC order before it is flattened, so ``w1``'s 320 rows read the
    features in the reference's order."""
    def conv(h, w):
        return F.conv2d(h, w.permute(3, 2, 0, 1))

    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.relu(conv(h, params["c1"])), 2)   # (B,10,12,12)
    h = F.max_pool2d(torch.relu(conv(h, params["c2"])), 2)   # (B,20,4,4)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def cnn_loss(params: dict, batch: dict) -> torch.Tensor:
    return cross_entropy(_cnn_logits(params, batch["x"]), batch["y"])


def cnn_accuracy(params: dict, batch: dict) -> torch.Tensor:
    logits = _cnn_logits(params, batch["x"])
    return _fraction_correct(logits.argmax(-1) == batch["y"])


# -- client quadratics (Theorem 1 / 3 closed forms) ---------------------------

def quad_loss(params: dict, batch: dict) -> torch.Tensor:
    """F_i(x) = 0.5 ||A x - b||^2 + c0, strongly convex, non-negative."""
    r = batch["A"] @ params["x"] - batch["b"]
    return 0.5 * torch.dot(r, r) + batch["c0"]


def quad_global_opt(As: torch.Tensor, bs: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """argmin Σ_i w_i · ½‖A_i x − b_i‖² = (Σ w_i A_iᵀA_i)⁻¹ Σ w_i A_iᵀ b_i."""
    H = torch.einsum("i,iab,iac->bc", weights, As, As)
    g = torch.einsum("i,iab,ia->b", weights, As, bs)
    return torch.linalg.solve(H, g)
