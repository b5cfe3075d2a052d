"""Federated round batching: the (M, k_max, B, …) microbatch tensors the
round engine loops over.

Each client re-samples with replacement from its own partition from the
numpy stream ``default_rng((seed, t))`` — the same stream as
``repro.data.pipeline.FederatedBatcher``, so round ``t``'s batches are
bit-identical in both packages.  Rows are gathered on the host and moved to
the device once per round (``round_batches``) or once per chunk of rounds
(``chunk_batches``).  Under partial participation each client draws from
its own stream ``default_rng((seed, t, i))`` (``client_indices``), so its
batches are the same whichever cohort it lands in, and only the cohort's
rows are gathered (``cohort_batches``, ``chunk_cohort_batches``).
``LMFederatedBatcher`` does the same over per-client token streams
(``repro.data.pipeline.LMFederatedBatcher``, bit-identical given the same
streams).  The device-side samplers (``DeviceBatcher``) wait for ROADMAP
A5.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device


class FederatedBatcher:
    """Per-round microbatch sampler over client partitions."""

    def __init__(self, data: Dataset, parts: list[np.ndarray],
                 batch_size: int, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.data = data
        self.parts = parts
        self.m = len(parts)
        self.batch_size = batch_size
        self.seed = seed
        n_total = sum(len(p) for p in parts)
        self.weights = torch.tensor([len(p) / n_total for p in parts],
                                    dtype=torch.float32, device=self.device)
        self._x = data.x.numpy()
        self._y = data.y.numpy()

    def round_indices(self, t: int, k_max: int) -> np.ndarray:
        """(M, k_max, B) dataset row indices for round ``t``."""
        rng = np.random.default_rng((self.seed, t))
        return np.stack([
            part[rng.integers(0, len(part), (k_max, self.batch_size))]
            for part in self.parts])

    def _gather(self, idx: np.ndarray) -> dict:
        return {"x": torch.from_numpy(self._x[idx]).to(self.device),
                "y": torch.from_numpy(self._y[idx]).to(self.device)}

    def round_batches(self, t: int, k_max: int) -> dict:
        """(M, k_max, B, …) feature/label tensors for round ``t``."""
        return self._gather(self.round_indices(t, k_max))

    def chunk_batches(self, t0: int, r: int, k_max: int) -> dict:
        """(R, M, k_max, B, …) stacked rounds ``t0 … t0+r-1`` — one gather
        and one host→device transfer per chunk.  Round ``t``'s slice is
        bit-identical to ``round_batches(t, k_max)``."""
        return self._gather(np.stack([self.round_indices(t0 + j, k_max)
                                      for j in range(r)]))

    # -- cohort-indexed sampling (partial participation) ---------------------

    def client_indices(self, t: int, i: int, k_max: int) -> np.ndarray:
        """(k_max, B) dataset rows for client ``i``'s round-``t`` draw from
        its own ``(seed, t, i)`` stream."""
        rng = np.random.default_rng((self.seed, t, i))
        part = self.parts[i]
        return part[rng.integers(0, len(part), (k_max, self.batch_size))]

    def cohort_indices(self, t: int, cohort: np.ndarray,
                       k_max: int) -> np.ndarray:
        """(C, k_max, B) rows for the sampled cohort only — O(C), not
        O(M)."""
        return np.stack([self.client_indices(t, int(i), k_max)
                         for i in cohort])

    def cohort_batches(self, t: int, cohort: np.ndarray, k_max: int
                       ) -> dict:
        """(C, k_max, B, …) feature/label tensors of round ``t``'s
        cohort."""
        return self._gather(self.cohort_indices(t, cohort, k_max))

    def chunk_cohort_batches(self, t0: int, cohorts: np.ndarray,
                             k_max: int) -> dict:
        """(R, C, k_max, B, …) stacked cohort rounds; ``cohorts`` is the
        (R, C) id matrix of rounds ``t0 … t0+R-1``.  One gather and one
        host→device transfer per chunk."""
        return self._gather(np.stack(
            [self.cohort_indices(t0 + j, cohorts[j], k_max)
             for j in range(cohorts.shape[0])]))


class LMFederatedBatcher:
    """Token-stream version: each client owns a topic-skewed stream
    (``{"tokens", "labels"}`` of shape ``(n_seq, S)``, tensors or numpy
    arrays); round ``t`` draws ``(k_max, B)`` sequence indices per client,
    in client order, from ``default_rng((seed, t))``."""

    def __init__(self, streams: list[dict], batch_size: int, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.m = len(streams)
        self.batch_size = batch_size
        self.seed = seed
        n_total = sum(s["tokens"].shape[0] for s in streams)
        self.weights = torch.tensor(
            [s["tokens"].shape[0] / n_total for s in streams],
            dtype=torch.float32, device=self.device)
        self._toks = [np.asarray(s["tokens"]) for s in streams]
        self._labs = [np.asarray(s["labels"]) for s in streams]

    def round_indices(self, t: int, k_max: int) -> list[np.ndarray]:
        """Per client, the (k_max, B) sequence indices of round ``t``."""
        rng = np.random.default_rng((self.seed, t))
        return [rng.integers(0, tok.shape[0], (k_max, self.batch_size))
                for tok in self._toks]

    def _gather(self, rounds: list[list[np.ndarray]]) -> dict:
        toks = np.stack([np.stack([tok[i] for tok, i in zip(self._toks, idx)])
                         for idx in rounds])
        labs = np.stack([np.stack([lab[i] for lab, i in zip(self._labs, idx)])
                         for idx in rounds])
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "labels": torch.from_numpy(labs).to(self.device)}

    def round_batches(self, t: int, k_max: int) -> dict:
        """(M, k_max, B, S) token / label tensors for round ``t``."""
        return {k: v[0] for k, v in
                self._gather([self.round_indices(t, k_max)]).items()}

    def chunk_batches(self, t0: int, r: int, k_max: int) -> dict:
        """(R, M, k_max, B, S) stacked rounds ``t0 … t0+r-1`` — one gather
        and one host→device transfer per chunk; round ``t``'s slice is
        bit-identical to ``round_batches(t, k_max)``."""
        return self._gather([self.round_indices(t0 + j, k_max)
                             for j in range(r)])
