"""Request workload generators for the serving testbed/benchmarks.

Arrival generation is shared with the simulator's request-level traffic
plane (`repro_torch.core.traffic`): the same batched order-statistics sampler
produces both the testbed's wall-clock schedules and the simulator's
bulk per-chunk streams, so testbed and simulation runs draw from the
same arrival-process family (Poisson, optionally diurnally modulated).
"""

from __future__ import annotations

import random
import time
from typing import List

import numpy as np

from repro_torch.core.traffic import diurnal_arrival_times, poisson_arrival_times
from repro_torch.serving.engine import Request


def make_request(rng: random.Random, rid: str, vocab: int,
                 prompt_len=(8, 8), new_tokens=(2, 6)) -> Request:
    """Fixed prompt length by default: the engine's prefill is jitted per
    shape, so clients use one bucket to avoid recompiles on the hot path."""
    S = rng.randint(*prompt_len)
    return Request(
        id=rid,
        prompt=np.asarray([rng.randrange(vocab) for _ in range(S)],
                          np.int32),
        max_new_tokens=rng.randint(*new_tokens),
        submitted_at=time.monotonic())


def _np_rng(rng: random.Random) -> np.random.Generator:
    """Derive a numpy generator from the caller's seeded random.Random
    so existing call sites keep their (seed-driven) determinism."""
    return np.random.default_rng(rng.getrandbits(64))


def poisson_arrivals(rng: random.Random, rate_hz: float,
                     duration_s: float) -> List[float]:
    """Arrival offsets (s) of a Poisson process over [0, duration).

    Delegates to the vectorized shared layer (one batched draw instead
    of N sequential exponentials).
    """
    return poisson_arrival_times(_np_rng(rng), rate_hz,
                                 0.0, duration_s).tolist()


def diurnal_arrivals(rng: random.Random, base_rate_hz: float,
                     duration_s: float, *, period_s: float = 240.0,
                     amplitude: float = 0.5) -> List[float]:
    """Arrival offsets of a diurnally-modulated Poisson process."""
    return diurnal_arrival_times(_np_rng(rng), base_rate_hz,
                                 0.0, duration_s, period=period_s,
                                 amplitude=amplitude).tolist()
