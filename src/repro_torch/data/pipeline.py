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
streams).

The device batchers (``DeviceBatcher``, ``DeviceLMBatcher``) keep the
dataset and a padded ``(M, L)`` index table on their device and draw
client i's round-t rows there: ``randint`` on the key ``fold_in(fold_in(
PRNGKey(seed), t), i)``, the reference's own keyed draw.  The O(r·C)
keys of a chunk's ``(round, client)`` pairs are folded on the host
(``fed/keyed.py``), one small copy goes to the device, and the
``(r, C, k_max, B)`` bits and indices are drawn there by ``keyed``'s
tensor twin in one threefry pass.  So row i of every method equals
``sample_row(t, i)`` and the reference's ``DeviceBatcher`` row, bit for
bit, with no host gather and no batch transfer.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.fed import keyed


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


def _host_ints(v) -> np.ndarray:
    """Round indices or client ids as a host int64 array (a tensor is read
    from its device)."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v, np.int64)


class _KeyedRows:
    """The device batchers' shared draw: per (round, client) keyed
    ``randint`` rows of a padded ``(M, L)`` table of per-client row ids on
    the device (pad slots are never drawn: ``idx < sizes[i]``)."""

    def _init_rows(self, sizes: np.ndarray, seed: int) -> None:
        self.seed = seed
        self._sizes = torch.as_tensor(sizes, dtype=torch.int64,
                                      device=self.device)
        self._key = keyed.prng_key(seed)

    def _as_index(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.int64, device=self.device)

    def draw(self, ts, ids, k_max: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The client ids broadcast to ``S`` on the device, and their
        ``(*S, k_max, B)`` draws in ``[0, sizes[i])``, for round indices
        ``ts`` and client ids ``ids`` (ints, arrays or tensors; read on the
        host, where their keys are folded) broadcast to ``S``."""
        ts, ids = np.broadcast_arrays(_host_ints(ts), _host_ints(ids))
        split = keyed.split(keyed.fold_in(keyed.fold_in(self._key, ts), ids))
        ids = self._as_index(ids)
        return ids, keyed.t_randint(self._as_index(split.astype(np.int64)),
                                    (k_max, self.batch_size),
                                    self._sizes[ids])


class DeviceBatcher(_KeyedRows):
    """Device-resident keyed sampler (``repro.data.pipeline.DeviceBatcher``
    counterpart): with replacement from each client's partition, keyed by
    ``(seed, round, client)``, the reference's indices bit for bit.
    Rounds and client ids may be ints or integer tensors."""

    def __init__(self, data: Dataset, parts: list[np.ndarray],
                 batch_size: int, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.data = data
        self.parts = parts
        self.m = len(parts)
        self.batch_size = batch_size
        sizes = np.array([len(p) for p in parts], np.int64)
        self.weights = torch.tensor(sizes / sizes.sum(), dtype=torch.float32,
                                    device=self.device)
        padded = np.zeros((self.m, int(sizes.max())), np.int64)
        for i, p in enumerate(parts):
            padded[i, :len(p)] = p
        self._table = torch.from_numpy(padded).to(self.device)
        self._x = data.x.to(self.device)
        self._y = data.y.to(self.device)
        self._init_rows(sizes, seed)

    def rows(self, ts, ids, k_max: int) -> torch.Tensor:
        """``(*S, k_max, B)`` dataset rows for rounds ``ts`` and clients
        ``ids`` broadcast to ``S``."""
        ids, u = self.draw(ts, ids, k_max)
        return self._table[ids[..., None, None], u]

    def _gather(self, idx: torch.Tensor) -> dict:
        return {"x": self._x[idx], "y": self._y[idx]}

    def row_indices(self, t, i, k_max: int) -> torch.Tensor:
        """(k_max, B) dataset rows for client ``i``'s round-``t`` draw."""
        return self.rows(t, i, k_max)

    def sample_row(self, t, i, k_max: int) -> dict:
        """One client's (k_max, B, …) microbatches (wave ``t``, client
        ``i``): the buffered engine's per-dispatch gather."""
        return self._gather(self.rows(t, i, k_max))

    def sample(self, t, k_max: int) -> dict:
        """The full (M, k_max, B, …) wave of round ``t``; row ``i`` equals
        ``sample_row(t, i)``."""
        return self._gather(self.rows(t, np.arange(self.m), k_max))

    def sample_cohort(self, t, cohort, k_max: int) -> dict:
        """(C, k_max, B, …) microbatches of a cohort; row j equals
        ``sample_row(t, cohort[j])`` whatever cohort the client is in."""
        return self._gather(self.rows(t, cohort, k_max))

    def sample_rows(self, ts, ids, k_max: int) -> dict:
        """``(*S, k_max, B, …)`` batches of rounds (waves) ``ts`` and
        clients ``ids`` broadcast to ``S``: one draw and one gather on the
        device (the buffered engine's ``(r, B)`` reports of a chunk)."""
        return self._gather(self.rows(ts, ids, k_max))

    def sample_chunk(self, ts, cohorts=None, k_max: int = 1) -> dict:
        """(r, C, k_max, B, …) batches of ``r`` rounds at once: round
        indices ``ts`` ``(r,)`` and the ``(r, C)`` cohorts (None: every
        client, C = M), one draw and one gather on the device."""
        if cohorts is None:
            cohorts = np.arange(self.m)[None]
        return self.sample_rows(_host_ints(ts)[:, None], cohorts, k_max)

    def round_batches(self, t: int, k_max: int) -> dict:
        return self.sample(t, k_max)


class DeviceLMBatcher(_KeyedRows):
    """Device-resident token sampler (``repro.data.pipeline.DeviceLMBatcher``
    counterpart): ``DeviceBatcher``'s keyed draw over per-client token
    streams padded into one ``(M, N_max, S)`` tensor; a row draws sequence
    indices ``idx < sizes[i]``, so pad rows are never read."""

    def __init__(self, streams: list[dict], batch_size: int, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.m = len(streams)
        self.batch_size = batch_size
        toks = [np.asarray(s["tokens"]) for s in streams]
        labs = [np.asarray(s["labels"]) for s in streams]
        sizes = np.array([t.shape[0] for t in toks], np.int64)
        self.weights = torch.tensor(sizes / sizes.sum(), dtype=torch.float32,
                                    device=self.device)
        shape = (self.m, int(sizes.max()), toks[0].shape[1])
        pt = np.zeros(shape, toks[0].dtype)
        pl = np.zeros(shape, labs[0].dtype)
        for i in range(self.m):
            pt[i, :sizes[i]] = toks[i]
            pl[i, :sizes[i]] = labs[i]
        self._toks = torch.from_numpy(pt).to(self.device)
        self._labs = torch.from_numpy(pl).to(self.device)
        self._init_rows(sizes, seed)

    def _sample(self, ts, ids, k_max: int) -> dict:
        ids, idx = self.draw(ts, ids, k_max)
        ids = ids[..., None, None]
        return {"tokens": self._toks[ids, idx],
                "labels": self._labs[ids, idx]}

    def sample_row(self, t, i, k_max: int) -> dict:
        """One client's (k_max, B, S) microbatches for wave ``t``."""
        return self._sample(t, i, k_max)

    def sample(self, t, k_max: int) -> dict:
        """(M, k_max, B, S) full wave; row ``i`` equals ``sample_row(t,
        i)``."""
        return self._sample(t, np.arange(self.m), k_max)

    def sample_cohort(self, t, cohort, k_max: int) -> dict:
        """(C, k_max, B, S) for a cohort, independent of membership."""
        return self._sample(t, cohort, k_max)

    def sample_rows(self, ts, ids, k_max: int) -> dict:
        """``(*S, k_max, B, S)`` batches of rounds ``ts`` and clients
        ``ids`` broadcast to ``S``."""
        return self._sample(ts, ids, k_max)

    def sample_chunk(self, ts, cohorts=None, k_max: int = 1) -> dict:
        """(r, C, k_max, B, S) batches of ``r`` rounds at once (None: every
        client)."""
        if cohorts is None:
            cohorts = np.arange(self.m)[None]
        return self._sample(_host_ints(ts)[:, None], cohorts, k_max)

    def round_batches(self, t: int, k_max: int) -> dict:
        return self.sample(t, k_max)


def eval_metric(metric_fn, params, data: Dataset, batch: int = 1024
                ) -> float:
    """Mean of ``metric_fn(params, {"x", "y"})`` over the dataset, in the
    reference's batch order: each batch's float32 value times its size,
    summed as Python floats."""
    n = len(data)
    total, count = 0.0, 0
    for s in range(0, n, batch):
        b = {"x": data.x[s:s + batch], "y": data.y[s:s + batch]}
        k = b["y"].shape[0]
        total += float(metric_fn(params, b)) * k
        count += k
    return total / max(count, 1)
