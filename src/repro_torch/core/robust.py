"""Byzantine-robust aggregation (``repro.core.robust`` counterpart): the
``DEFENSES`` registry, the health quarantine and the final non-finite
guard.

Threat model: a client payload — the delta rows ``x_i − anchor`` and the
ν transmit rows, what crosses the wire — may be arbitrary: NaN/Inf,
maliciously scaled, sign-flipped or resampled noise (the attacks are
``fed/scenarios.py``).  FedaGrac is more exposed than FedAvg: a bad row
poisons the model and the broadcast orientation ν, and through ν every
client's next local direction.  So the defense sits at the same point on
both payloads:

    delta rows ─ sanitize → quarantine → defend → HT-renormalize ─→ agg
    ν rows     ─ sanitize → quarantine → [defend if nu_defense] ─→ ν mix

``defense="none"`` with ``quarantine_window=0`` is no stage at all:
``RobustConfig.from_fed`` returns ``None`` and the rounds run unchanged.

Pipeline contract (``RoundRobust.model`` / ``.nu``): inputs are ``(B, P)``
lane-padded rows and ``(B,)`` weights; padding columns are zeroed, rows
with any non-finite value are dropped, quarantined clients (``hz_until[id]
> round`` in the PRE-round state, ``RoundRobust.quarantined``) are
dropped, the defense may drop more (krum) or recentre (median,
trimmed_mean), and Horvitz–Thompson renormalization rescales the surviving
weights so their sum is the original total.  If nothing survives, the
original weights are kept and every row is zeroed: the round is a no-op.

Health state: five ``(M,)`` vectors (``ROBUST_STATE_KEYS``) — running
non-finite counts and an EWMA of delta norms; a client is quarantined for
``quarantine_window`` rounds when its non-finite count reaches
``quarantine_nonfinite`` or its norm z-score exceeds ``quarantine_z``
after ``HEALTH_WARMUP`` finite reports.  Where an id repeats in one
report set (a buffered reporter reporting twice), the counters accumulate
(``index_add_``, as ``.at[].add``) and the EWMA and quarantine rows keep
the last occurrence's values (``stages.last_occurrence``).

Everything here is plain torch on the round's device tensors, as the
reference's is jnp outside any Pallas kernel; nothing reads the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.tree_util import tree_leaves, tree_map

_EPS = 1e-12
# finite sentinel for sort/distance padding — NOT inf, so the pairwise
# krum distances never produce inf − inf = NaN under masking
_BIG = 1e30
HEALTH_EWMA = 0.2        # EWMA step for the per-client delta-norm stats
HEALTH_WARMUP = 3        # finite reports required before z-score flagging

# the extra (M,) state vectors of an active quarantine
ROBUST_STATE_KEYS = ("hz_nonfinite", "hz_mean", "hz_var", "hz_count",
                     "hz_until")


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Resolved robustness knobs; ``from_fed`` returns None when inactive,
    and the rounds then run unchanged."""
    defense: str = "none"
    clip_norm: float = 0.0      # 0 → adaptive: median of surviving norms
    trim_frac: float = 0.2
    krum_f: int = 1
    nu_defense: bool = True     # ablation knob: defend ν too, not just x
    quarantine_window: int = 0
    quarantine_z: float = 4.0
    quarantine_nonfinite: int = 1

    @classmethod
    def from_fed(cls, fed) -> Optional["RobustConfig"]:
        if fed.defense == "none" and fed.quarantine_window == 0:
            return None
        return cls(defense=fed.defense, clip_norm=fed.defense_clip,
                   trim_frac=fed.trim_frac, krum_f=fed.krum_f,
                   nu_defense=fed.nu_defense,
                   quarantine_window=fed.quarantine_window,
                   quarantine_z=fed.quarantine_z,
                   quarantine_nonfinite=fed.quarantine_nonfinite)

    @property
    def defends(self) -> bool:
        return self.defense != "none"

    @property
    def quarantines(self) -> bool:
        return self.quarantine_window > 0


# ---------------------------------------------------------------------------
# defense transforms — factories (cfg, n) -> fn(rows, mask) -> (rows, mask)
#
# Invariants on entry: rows are float32, padding columns zeroed, dead rows'
# DATA zeroed (0·NaN = NaN in a downstream sum).  A transform may shrink
# the mask (krum) but never grows it.
# ---------------------------------------------------------------------------

def _nanmedian(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian(where(mask, vals, nan), axis=0)`` with NaN → 0: the
    median over the live rows along axis 0, the MEAN of the two middle
    values for an even live count (``torch.median`` takes the lower one),
    0 where no row lives.  The middle positions come from the device
    count, so nothing reads the host."""
    live = mask.sum()
    srt = torch.sort(torch.where(mask.view((-1,) + (1,) * (vals.dim() - 1)),
                                 vals, float("inf")), dim=0).values
    lo = torch.clamp((live - 1) // 2, min=0).view(1)
    hi = torch.clamp(live // 2, min=0).view(1)
    med = ((srt.index_select(0, lo) + srt.index_select(0, hi)) * 0.5)[0]
    return torch.where(live > 0, med, 0.0)


def _none(cfg: RobustConfig, n: int):
    def fn(rows, mask):
        return rows, mask
    return fn


def _clip(cfg: RobustConfig, n: int):
    """Per-client norm clipping; threshold fixed (clip_norm > 0) or the
    median of the surviving rows' norms (adaptive)."""
    def fn(rows, mask):
        norms = torch.sqrt(torch.sum(rows * rows, dim=-1))
        if cfg.clip_norm > 0:
            tau = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                               device=rows.device)
        else:
            tau = _nanmedian(norms, mask)
        scale = torch.where(norms > tau, tau / torch.clamp(norms, min=_EPS),
                            1.0)
        return rows * scale[:, None], mask
    return fn


def _median(cfg: RobustConfig, n: int):
    """Coordinate-wise median over surviving rows, broadcast back to every
    survivor — the weighted mean downstream then returns the median."""
    def fn(rows, mask):
        center = _nanmedian(rows, mask)
        out = torch.where(mask[:, None], center[None, :], 0.0)
        return out, mask
    return fn


def _trimmed_mean(cfg: RobustConfig, n: int):
    """Coordinate-wise trimmed mean: per column, sort the surviving values
    (dead rows pushed past the live range with a finite sentinel), drop the
    k smallest and k largest, average the middle."""
    def fn(rows, mask):
        b = rows.shape[0]
        k = max(1, int(round(cfg.trim_frac * b)))      # half to even
        live = mask.sum()
        srt = torch.sort(torch.where(mask[:, None], rows, _BIG),
                         dim=0).values
        idx = torch.arange(b, device=rows.device)
        keep = (idx >= k) & (idx < live - k)
        denom = torch.clamp(live - 2 * k, min=1).float()
        center = torch.sum(torch.where(keep[:, None], srt, 0.0),
                           dim=0) / denom
        out = torch.where(mask[:, None], center[None, :], 0.0)
        return out, mask
    return fn


def _krum(cfg: RobustConfig, n: int):
    """Multi-krum distance filtering: score each row by the sum of squared
    distances to its q = B − f − 2 nearest survivors, keep the B − f
    lowest-scoring rows (drop the f most isolated)."""
    def fn(rows, mask):
        b = rows.shape[0]
        f = max(0, int(cfg.krum_f))
        sq = torch.sum((rows[:, None, :] - rows[None, :, :]) ** 2, dim=-1)
        dead = ~mask
        sq = torch.where(dead[:, None] | dead[None, :], _BIG, sq)
        sq = sq + torch.eye(b, dtype=sq.dtype, device=sq.device) * _BIG
        q = max(b - f - 2, 1)
        scores = torch.sum(torch.sort(sq, dim=1).values[:, :q], dim=1)
        scores = torch.where(mask, scores, float("inf"))
        keep_n = max(b - f, 1)
        order = torch.argsort(scores, stable=True)
        # index_fill_ takes the value as a scalar: an item assignment
        # would copy a host tensor to the card and synchronise
        sel = torch.zeros(b, dtype=torch.bool, device=rows.device
                          ).index_fill_(0, order[:keep_n], True)
        new_mask = mask & sel
        return torch.where(new_mask[:, None], rows, 0.0), new_mask
    return fn


DEFENSES = {
    "none": _none,
    "clip": _clip,
    "median": _median,
    "trimmed_mean": _trimmed_mean,
    "krum": _krum,
}


# ---------------------------------------------------------------------------
# pipeline pieces
# ---------------------------------------------------------------------------

def _renorm(rows_f: torch.Tensor, out_dtype: torch.dtype,
            weights: torch.Tensor, mask: torch.Tensor):
    """Horvitz–Thompson renormalization: rescale surviving weights so Σw is
    preserved (the aggregators and the ν mass-mix key on it).  If nothing
    survives, keep the ORIGINAL weights and zero every row — the weighted
    mean then returns the anchor (a no-op round)."""
    mf = mask.float()
    tot0 = torch.sum(weights)
    w1 = weights * mf
    alive = torch.sum(w1)
    ok = alive > 0
    scale = torch.where(ok, tot0 / torch.clamp(alive, min=_EPS), 0.0)
    w_out = torch.where(ok, w1 * scale, weights)
    rows_out = torch.where(ok, rows_f * mf[:, None], 0.0)
    return rows_out.to(out_dtype), w_out


def _rows_at_last(rows: torch.Tensor, last: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    return rows if last is None else rows.index_select(0, last)


def _health_update(cfg: RobustConfig, state: dict, new_state: dict,
                   ids: torch.Tensor, rfin: torch.Tensor,
                   finite: torch.Tensor, quar: torch.Tensor, r, *,
                   last: Optional[torch.Tensor] = None,
                   in_place: bool = False) -> None:
    """Update the per-client health vectors from this round's reports.

    ``rfin`` is finite-masked (NOT quarantine-masked): quarantined rows
    freeze their EWMA (``upd``) so a quarantine never drags the baseline
    toward zero.  z-scores use the PRE-update stats, so a client cannot
    shift its own baseline in the round it attacks.  ``in_place=True``
    writes the state's own vectors (a caller that owns the state); every
    read of the old values comes first."""
    a = HEALTH_EWMA
    norms = torch.sqrt(torch.sum(rfin * rfin, dim=-1))
    mean_g = state["hz_mean"].index_select(0, ids)
    var_g = state["hz_var"].index_select(0, ids)
    cnt_g = state["hz_count"].index_select(0, ids)
    until_g = state["hz_until"].index_select(0, ids)

    def store(key):
        return state[key] if in_place else state[key].clone()

    nf1 = store("hz_nonfinite").index_add_(
        0, ids, (~finite).to(state["hz_nonfinite"].dtype))
    upd = finite & ~quar
    z = (norms - mean_g) * torch.rsqrt(var_g + _EPS)
    zbad = upd & (cnt_g >= HEALTH_WARMUP) & (z > cfg.quarantine_z)
    nfbad = (~finite) & (nf1.index_select(0, ids)
                         >= cfg.quarantine_nonfinite)
    flag = zbad | nfbad
    new_until = torch.where(flag, r + 1 + cfg.quarantine_window, until_g
                            ).to(until_g.dtype)
    first = cnt_g == 0
    m1 = torch.where(first, norms, (1 - a) * mean_g + a * norms)
    m1 = torch.where(upd, m1, mean_g)
    v1 = torch.where(first, torch.zeros_like(var_g),
                     (1 - a) * var_g + a * (norms - m1) ** 2)
    v1 = torch.where(upd, v1, var_g)
    new_state["hz_nonfinite"] = nf1
    new_state["hz_mean"] = store("hz_mean").index_copy_(
        0, ids, _rows_at_last(m1, last))
    new_state["hz_var"] = store("hz_var").index_copy_(
        0, ids, _rows_at_last(v1, last))
    new_state["hz_count"] = store("hz_count").index_add_(
        0, ids, upd.to(state["hz_count"].dtype))
    new_state["hz_until"] = store("hz_until").index_copy_(
        0, ids, _rows_at_last(new_until, last))


def init_robust_state(state: dict, robust: Optional[RobustConfig],
                      n_clients: int) -> dict:
    """Allocate the (M,) health vectors when quarantine is on."""
    if robust is None or not robust.quarantines:
        return state
    dev = tree_leaves(state["params"])[0].device
    for key, dtype in zip(ROBUST_STATE_KEYS,
                          (torch.int32, torch.float32, torch.float32,
                           torch.int32, torch.int32)):
        state[key] = torch.zeros((n_clients,), dtype=dtype, device=dev)
    return state


def guard(new, old):
    """``old`` wherever ``new`` is non-finite, leaf by leaf (the final
    stage: a defended run never writes NaN into the server state)."""
    return tree_map(lambda a, b: torch.where(torch.isfinite(a), a, b),
                    new, old)


@dataclasses.dataclass(frozen=True)
class RoundRobust:
    """The robust stages of one round builder.

    ``quarantined(state, r, ids)`` → ``(B,)`` bool, read from the PRE-round
    state once per round; ``model(rows, weights, state, new_state, r, ids,
    quar, *, last, in_place)`` → ``(rows, weights, quarantined count)``;
    ``nu(rows, weights, quar)`` → ``(rows, weights)``; ``guard(new, old)``
    keeps ``old`` wherever ``new`` is non-finite."""
    config: RobustConfig
    n: int
    quarantined: Callable
    model: Callable
    nu: Callable
    guard: Callable


def build_round_robust(robust: Optional[RobustConfig], spec,
                       uses_nu: bool) -> Optional[RoundRobust]:
    if robust is None:
        return None
    if spec is None:
        raise ValueError("robust aggregation requires a FlatSpec")
    cfg = robust
    n = spec.n
    defense_fn = DEFENSES[cfg.defense](cfg, n)

    def _sanitize(rows):
        rf = rows.float()
        rf = torch.where(torch.arange(rf.shape[-1], device=rf.device) < n,
                         rf, 0.0)
        return rf, torch.all(torch.isfinite(rf), dim=-1)

    def quarantined(state, r, ids):
        if not cfg.quarantines:
            return torch.zeros(ids.shape, dtype=torch.bool,
                               device=ids.device)
        return state["hz_until"].index_select(0, ids) > r

    def model(rows, weights, state, new_state, r, ids, quar, *, last=None,
              in_place=False):
        rf0, finite = _sanitize(rows)
        if cfg.quarantines:
            qcount = torch.sum(quar.float())
            rfin = torch.where(finite[:, None], rf0, 0.0)
            _health_update(cfg, state, new_state, ids, rfin, finite, quar,
                           r, last=last, in_place=in_place)
        else:
            qcount = torch.zeros((), dtype=torch.float32,
                                 device=rows.device)
        mask = finite & ~quar
        rf = torch.where(mask[:, None], rf0, 0.0)
        rf, mask = defense_fn(rf, mask)
        rows_out, w_out = _renorm(rf, rows.dtype, weights, mask)
        return rows_out, w_out, qcount

    def nu(rows, weights, quar):
        rf0, finite = _sanitize(rows)
        mask = finite & ~quar
        rf = torch.where(mask[:, None], rf0, 0.0)
        if cfg.defends and cfg.nu_defense:
            rf, mask = defense_fn(rf, mask)
        return _renorm(rf, rows.dtype, weights, mask)

    return RoundRobust(config=cfg, n=n, quarantined=quarantined,
                       model=model, nu=nu, guard=guard)


def guarded_rows(rows, store, ids: torch.Tensor):
    """The guard on rows about to be written into an ``(M, …)`` store at
    ``ids`` (leaf by leaf): each non-finite element takes the store's
    current value, as ``guard(new store, old store)`` would after the
    write."""
    return tree_map(lambda r, s: guard(r, s.index_select(0, ids).to(
        r.dtype)), rows, store)

