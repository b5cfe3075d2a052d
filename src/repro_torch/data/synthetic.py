"""Synthetic federated datasets.

``fedprox_synthetic`` is the canonical non-IID task the paper-scale
experiments run (Li et al., FedProx synthetic(α, β)).  It is drawn with
numpy, so fed the same integer seed it gives the same bits as
``repro.data.synthetic.fedprox_synthetic`` — which derives that integer from
a ``jax.random`` key; here the caller passes it directly.

``quadratic_clients`` draws the per-client quadratics of the Theorem-1/3
checks with numpy from an integer seed, bit for bit as the reference does
from the integer it takes from its key.  ``gaussian_classification`` and
``image_classification`` (the a9a / Fashion-MNIST stand-ins) draw from an
explicit ``torch.Generator``: they follow the reference's law, not its
``jax.random`` stream, so parity tests pass the reference's arrays in.

``token_stream`` / ``lm_sequences`` are the federated LM task's Zipf token
streams with a per-client topic band, the reference's law drawn from a
numpy seed: ``jax.random.choice`` has no numpy or torch twin, so the
streams differ from the reference's, and parity tests feed both packages
the reference's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Dataset:
    """In-memory supervised dataset (features x, int labels y), host-side:
    batchers gather rows on the host and move them to the device in one
    transfer per chunk."""
    x: torch.Tensor
    y: torch.Tensor

    def __len__(self) -> int:
        return self.x.shape[0]


def fedprox_synthetic(seed: int, m: int, alpha: float = 1.0,
                      beta: float = 1.0, d: int = 60, n_classes: int = 10,
                      n_per_client: int = 400, iid: bool = False):
    """Synthetic(α, β) from Li et al. (FedProx).  Client i draws a local
    softmax model W_i ~ N(u_i, 1), u_i ~ N(0, α), and features
    x ~ N(v_i, Λ), v_i ~ N(B_i, 1), B_i ~ N(0, β), Λ_jj = j^{-1.2}.

    Returns (Dataset over the union — x float32, y int32 — and the list of
    per-client index arrays)."""
    rng = np.random.default_rng(seed)
    lam = np.diag(np.arange(1, d + 1, dtype=np.float64) ** -1.2)
    xs, ys, parts = [], [], []
    offset = 0
    W_shared = rng.normal(0, 1.0, size=(d, n_classes))
    b_shared = rng.normal(0, 1.0, size=(n_classes,))
    for _ in range(m):
        if iid:
            W, b, v = W_shared, b_shared, np.zeros(d)
        else:
            u = rng.normal(0, np.sqrt(alpha))
            W = rng.normal(u, 1.0, size=(d, n_classes))
            b = rng.normal(u, 1.0, size=(n_classes,))
            Bi = rng.normal(0, np.sqrt(beta))
            v = rng.normal(Bi, 1.0, size=(d,))
        x = rng.multivariate_normal(v, lam, size=n_per_client)
        logits = x @ W + b
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        y = np.array([rng.choice(n_classes, p=pi) for pi in p])
        xs.append(x.astype(np.float32))
        ys.append(y.astype(np.int32))
        parts.append(np.arange(offset, offset + n_per_client))
        offset += n_per_client
    data = Dataset(x=torch.from_numpy(np.concatenate(xs)),
                   y=torch.from_numpy(np.concatenate(ys)))
    return data, parts


def gaussian_classification(generator: torch.Generator, n: int,
                            d: int = 32, n_classes: int = 10,
                            sep: float = 2.0, noise: float = 1.0
                            ) -> Dataset:
    """Gaussian blobs: class c centred at sep·μ_c, unit covariance.  Drawn
    on the generator's device; the dataset is returned on the host."""
    dev = generator.device
    mus = torch.randn(n_classes, d, generator=generator, device=dev) * sep
    y = torch.randint(0, n_classes, (n,), generator=generator, device=dev)
    x = mus[y] + torch.randn(n, d, generator=generator, device=dev) * noise
    return Dataset(x=x.cpu(), y=y.to(torch.int32).cpu())


def image_classification(generator: torch.Generator, n: int,
                         n_classes: int = 10, side: int = 28,
                         noise: float = 0.35) -> Dataset:
    """Class-templated grey-scale images ``(n, side, side, 1)`` (NHWC, as
    the reference's), templates in (0, 1).  Drawn on the generator's
    device; the dataset is returned on the host."""
    dev = generator.device
    templates = torch.sigmoid(2.0 * torch.randn(
        n_classes, side, side, 1, generator=generator, device=dev))
    y = torch.randint(0, n_classes, (n,), generator=generator, device=dev)
    x = templates[y] + torch.randn(n, side, side, 1, generator=generator,
                                   device=dev) * noise
    return Dataset(x=x.cpu(), y=y.to(torch.int32).cpu())


def quadratic_clients(seed: int, m: int, d: int = 16, hetero: float = 1.0,
                      cond: float = 4.0):
    """Per-client F_i(x) = ½‖A_i x − b_i‖².

    ``hetero`` scales the spread of the per-client optima x*_i (0 ⇒ IID:
    identical b_i); ``cond`` the condition-number spread of A_i.  Returns
    (As (m, d, d), bs (m, d)) float32 numpy arrays for core/theory.py."""
    rng = np.random.default_rng(seed)
    As, bs = [], []
    b_common = rng.normal(size=d)
    for _ in range(m):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        eig = np.exp(rng.uniform(0.0, np.log(cond), size=d))
        A = q * np.sqrt(eig)                       # AᵀA = QΛQᵀ
        b = b_common + hetero * rng.normal(size=d)
        As.append(A.astype(np.float32))
        bs.append(b.astype(np.float32))
    return np.stack(As), np.stack(bs)


def token_probs(vocab: int, skew_topic: Optional[int] = None,
                zipf_a: float = 1.2) -> np.ndarray:
    """Zipf(``zipf_a``) over token ranks; ``skew_topic`` boosts a band of
    ``vocab // 8`` tokens eightfold, so clients with different topics are
    non-IID at the unigram level (the reference's ``token_stream`` law)."""
    probs = np.arange(1, vocab + 1, dtype=np.float64) ** (-zipf_a)
    if skew_topic is not None:
        band = vocab // 8
        start = (skew_topic * band) % max(vocab - band, 1)
        probs[start:start + band] *= 8.0
    return probs / probs.sum()


def token_stream(seed: int, n_tokens: int, vocab: int,
                 skew_topic: Optional[int] = None,
                 zipf_a: float = 1.2) -> torch.Tensor:
    """(n_tokens,) int32 token ids on the host, drawn from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(vocab, n_tokens, p=token_probs(vocab, skew_topic,
                                                    zipf_a))
    return torch.from_numpy(ids.astype(np.int32))


def lm_sequences(seed: int, n_seq: int, seq_len: int, vocab: int,
                 skew_topic: Optional[int] = None) -> dict:
    """(tokens, labels) next-token pairs of shape (n_seq, seq_len)."""
    chunks = token_stream(seed, n_seq * (seq_len + 1), vocab,
                          skew_topic).reshape(n_seq, seq_len + 1)
    return {"tokens": chunks[:, :-1], "labels": chunks[:, 1:]}
