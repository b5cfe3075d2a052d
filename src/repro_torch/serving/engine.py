"""Continuous-batching serving engine (``repro.serving.engine``
counterpart).

A fixed pool of B cache slots; arriving requests prefill into free slots,
right-padded to a bucket length; every engine tick decodes ONE token for
ALL slots in a single batched call — the cache keeps per-row ring
positions (models/attention.py), so slots at different phases coexist in
one pool and a finished request frees its slot at once.  Every prefill's
attention runs the flash kernel on the card (its plain version on the
CPU); decode attention is plain torch, as in the reference.

Sampling depends on the request alone: the default sampler is greedy
``argmax`` on the device; a custom ``sampler(logits_row, generator)`` gets
a ``torch.Generator`` seeded from ``(uid, step)`` only (step = tokens
already emitted), so a completion never depends on co-scheduled traffic or
admission order.  It cannot reproduce the reference's
``fold_in(PRNGKey(uid), step)`` draws.

The engine runs on the card (``device=None``, raising where there is none)
unless given ``device="cpu"``, and every step runs under
``torch.inference_mode()``.  The prefill is functional (it never writes
the one reusable single-slot cache template); ``_write_slot`` splices the
filled row into the pool in place.  Subclasses resolve per-request
parameter views through the ``_prefill_slot`` / ``_decode_tick`` /
``_slot_version`` hooks (the reference's personalized engine, ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree_util import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1 = never stops early
    client_id: int = 0                 # personalization key


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]
    prompt_len: int
    ticks: int                         # decode ticks consumed
    client_id: int = 0
    version: int = 0                   # snapshot the request was served under


def sampling_seed(uid: int, step: int) -> int:
    """The generator seed of a request's ``step``-th token: a function of
    ``(uid, step)`` alone."""
    return ((uid & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


class ServeEngine:
    """``submit()`` requests, ``run()`` until drained.

    ``sampler(logits, generator) -> token`` works on ONE row of (V,)
    logits with that request's per-step generator; default: greedy argmax.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, prefill_buckets=(32, 64, 128, 256),
                 sampler: Optional[Callable] = None,
                 max_pending: int = 0,
                 device: Union[str, torch.device, None] = None):
        if cfg.frontend != "none":
            raise ValueError(f"the engine serves text models, not the "
                             f"{cfg.frontend} front end")
        if cfg.ssm is not None or cfg.xlstm is not None:
            raise ValueError(
                "right-padded prefill is exact for KV caches only; SSM "
                "state needs unpadded scans")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.slots = slots
        self.max_len = max_len
        self.buckets = tuple(b for b in sorted(prefill_buckets)
                             if b <= max_len)
        self.sampler = sampler
        dtype = getattr(torch, cfg.dtype)
        self.caches = model_lib.init_caches(cfg, slots, max_len, dtype,
                                            self.device)
        # ONE reusable single-slot cache: prefill is functional, so the
        # pristine template serves every admission
        self._single = model_lib.init_caches(cfg, 1, max_len, dtype,
                                             self.device)
        self.pos = np.zeros(slots, np.int32)        # next position per slot
        self.active: list[Optional[Request]] = [None] * slots
        self.emitted: dict[int, list[int]] = {}
        self.started: dict[int, int] = {}
        self.queue: deque[Request] = deque()
        self.done: list[Completion] = []
        self.ticks = 0
        # admission bound: with max_pending > 0 the queue is capped and a
        # submit into a full queue is SHED (counted, not raised); 0 keeps
        # the queue unbounded
        self.max_pending = max_pending
        self.dropped = 0

    # -- public api ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) > max(self.buckets):
            raise ValueError(f"prompt of {len(req.prompt)} tokens is longer "
                             f"than the largest bucket {max(self.buckets)}")
        if self.max_pending > 0 and len(self.queue) >= self.max_pending:
            self.dropped += 1
            return
        self.queue.append(req)

    @torch.inference_mode()
    def step(self) -> None:
        """One scheduler step: admit waiting requests into free slots, then
        decode one token for every live slot."""
        self._admit()
        self._tick()

    def run(self, max_ticks: int = 10_000) -> list[Completion]:
        while (self.queue or any(a is not None for a in self.active)) \
                and self.ticks < max_ticks:
            self.step()
        return self.done

    @property
    def utilization(self) -> float:
        return sum(a is not None for a in self.active) / self.slots

    # -- internals -----------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _sample(self, logits: torch.Tensor, rows: list[int],
                uids: list[int], steps: list[int]) -> list[int]:
        """Tokens for ``rows`` of (B, V) ``logits``, one host read."""
        if self.sampler is None:
            picked = logits.argmax(dim=-1).cpu()
            return [int(picked[r]) for r in rows]
        out = []
        for r, uid, step in zip(rows, uids, steps):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(sampling_seed(uid, step))
            out.append(int(self.sampler(logits[r], gen)))
        return out

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            n = len(req.prompt)
            b = self._bucket(n)
            padded = np.zeros((1, b), np.int64)
            padded[0, :n] = req.prompt                 # RIGHT-pad: prompt
            # tokens never attend pads (causal), pads are invalidated below
            toks = torch.from_numpy(padded).to(self.device)
            logits, single = self._prefill_slot(s, req, toks, self._single)
            single = _invalidate_pads(single, n, b)
            _write_slot(self.caches, single, s)
            tok = self._sample(logits[:, n - 1], [0], [req.uid], [0])[0]
            self.active[s] = req
            self.pos[s] = n
            self.emitted[req.uid] = [tok]
            self.started[req.uid] = self.ticks

    def _tick(self) -> None:
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return
        self.ticks += 1
        toks = np.zeros((self.slots, 1), np.int64)
        for s in live:
            toks[s, 0] = self.emitted[self.active[s].uid][-1]
        logits = self._decode_tick(toks, live)
        arr = self._sample(logits, live,
                           [self.active[s].uid for s in live],
                           [len(self.emitted[self.active[s].uid])
                            for s in live])
        for s, tok in zip(live, arr):
            req = self.active[s]
            self.emitted[req.uid].append(tok)
            self.pos[s] += 1
            n = len(self.emitted[req.uid])
            if n >= req.max_new_tokens or tok == req.eos_id:
                self.done.append(Completion(
                    uid=req.uid, tokens=self.emitted.pop(req.uid),
                    prompt_len=len(req.prompt),
                    ticks=self.ticks - self.started.pop(req.uid),
                    client_id=req.client_id,
                    version=self._slot_version(s)))
                self.active[s] = None
        for s in range(self.slots):
            if self.active[s] is None:
                self.pos[s] = 0         # park idle slots at position 0

    # -- subclass hooks ------------------------------------------------------

    def _prefill_slot(self, s: int, req: Request, toks: torch.Tensor,
                      caches: list):
        """Prefill into slot ``s`` — subclasses resolve per-request
        parameter views here.  Returns (full logits, filled 1-row cache);
        full logits, not the last position's: with right-padding the last
        REAL position differs per request."""
        logits, new_caches, _ = model_lib.forward(
            self.params, {"tokens": toks}, self.cfg, caches=caches)
        return logits, new_caches

    def _decode_tick(self, toks: np.ndarray, live: list[int]) -> torch.Tensor:
        """ONE batched decode at per-slot offsets; idle slots decode a
        dummy token into their own (soon-overwritten) rows.  Returns the
        (B, V) next-token logits."""
        logits, self.caches = model_lib.serve_decode(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            self.caches,
            torch.from_numpy(self.pos.copy()).to(self.device), self.cfg)
        return logits[:, 0]

    def _slot_version(self, s: int) -> int:
        return 0


def _invalidate_pads(single: list, n: int, b: int) -> list:
    """Mark the ring slots holding right-pad tokens as empty (pos = -1) so
    the per-row valid mask hides them from every later decode.  Returns a
    new cache list."""
    out = []
    for seg in single:
        seg = dict(seg)
        pos = seg.get("pos")
        if pos is not None and pos.dim() >= 2:
            size = pos.shape[-1]
            sl = torch.arange(size, device=pos.device)
            mask = ((sl >= n % max(size, 1)) & (sl < b) if size < b
                    else (sl >= n) & (sl < b))
            seg["pos"] = torch.where(mask, -1, pos)
        out.append(seg)
    return out


def _write_slot(pool: list, single: list, s: int) -> None:
    """Splice a 1-row cache list into row ``s`` of the pool, in place.
    Cache leaves carry (n_groups, count) stack dims, then the batch row."""
    for pseg, oseg in zip(pool, single):
        for key, p in pseg.items():
            o = oseg[key]
            if (p.dim() >= 3 and o.dim() == p.dim() and o.shape[2] == 1
                    and p.shape[:2] == o.shape[:2]):
                p[:, :, s:s + 1] = o.to(p.dtype)
