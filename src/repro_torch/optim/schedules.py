"""Learning-rate and calibration-rate schedules (``repro.optim.schedules``
counterpart).

The paper's Figure 2b "Increase" schedule steps λ upward over rounds
(0.1 → 0.5 → 1.0); it is ``lambda_increase``.  η schedules cover the
constant grids of §6 plus warmup-cosine for the LM examples.  Each schedule
takes a Python int or a tensor step and returns a float32 scalar tensor, as
the reference returns a ``jnp.float32``: its values round to float32 as the
reference's do, so ``float(lam_schedule(t))`` hands the round the same λ
(0.1 becomes 0.10000000149) in both packages."""
from __future__ import annotations

import math

import torch


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32)


def constant(value: float):
    return lambda step: _f32(value)


def cosine(base: float, total_steps: int, warmup: int = 0,
           floor: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = base * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (base - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def step_decay(base: float, boundaries: tuple[int, ...],
               factors: tuple[float, ...]):
    def fn(step):
        v = _f32(base)
        for b, f in zip(boundaries, factors):
            v = torch.where(_f32(step) >= b, _f32(base * f), v)
        return v
    return fn


def lambda_increase(boundaries: tuple[int, ...] = (50, 150),
                    values: tuple[float, ...] = (0.1, 0.5, 1.0)):
    """Paper Fig. 2b: λ = 0.1 for t<50, 0.5 for t<150, then 1.0."""
    if len(values) != len(boundaries) + 1:
        raise ValueError(f"{len(boundaries)} boundaries need "
                         f"{len(boundaries) + 1} values, got {len(values)}")

    def fn(t):
        v = _f32(values[0])
        for b, nxt in zip(boundaries, values[1:]):
            v = torch.where(_f32(t) >= b, _f32(nxt), v)
        return v
    return fn
