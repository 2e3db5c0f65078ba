"""The one traffic generator: a mix's data file in, a request schedule out.

A mix (``bench/traffic/<name>.json``) gives the arrival process, its rate
in requests a second, the prompt and output length distributions, and how
requests spread over the applications. ``schedule`` turns it, a seed and a
window length into the requests due in the window.

``"arrivals": "poisson-stratified"``, the one arrival process, gives every
seed the same set of inter-arrival gaps, prompt lengths and output lengths,
each in another order: the gaps are the exponential distribution's
quantiles at (i + 1/2) / n, scaled to fill the window, the lengths the
quantiles of their distributions. So the work of a window does not change
with the seed, only its order and its tokens do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class Arrival:
    idx: int
    t_due: float            # seconds after the window opens
    app: int                # index into the cell's applications
    prompt_len: int
    new_tokens: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.float64) + 0.5) / n


def _lengths(spec: Dict, u: np.ndarray) -> np.ndarray:
    """Lengths at quantiles ``u`` of ``spec``: ``loguniform`` or
    ``uniform`` over the integers [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return np.clip(lo + np.floor(u * (hi - lo + 1)), lo,
                       hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def schedule(mix: Dict, seed: int, seconds: float,
             n_apps: int) -> List[Arrival]:
    """The requests due in a window of ``seconds``, in due order."""
    rng = np.random.default_rng(seed)
    rate = float(mix["rate_rps"])
    if mix["arrivals"] != "poisson-stratified":
        raise ValueError(f"unknown arrival process {mix['arrivals']!r}")
    n = max(1, int(round(rate * seconds)))
    gaps = rng.permutation(-np.log1p(-_quantiles(n)) / rate)
    gaps *= seconds / gaps.sum()
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    u_prompt = rng.permutation(_quantiles(n))
    u_new = rng.permutation(_quantiles(n))
    if mix.get("apps", "even") != "even":
        raise ValueError(f"unknown app spread {mix['apps']!r}")
    apps = rng.permutation(np.arange(n) % n_apps)
    prompts = _lengths(mix["prompt"], u_prompt)
    new = _lengths(mix["new_tokens"], u_new)
    return [Arrival(i, float(times[i]), int(apps[i]), int(prompts[i]),
                    int(new[i])) for i in range(n)]


def prompt_tokens(seed: int, idx: int, length: int, vocab: int) -> np.ndarray:
    """Request ``idx``'s prompt: ``length`` token ids drawn from the seed
    and the request's index alone, so a resend carries the same prompt."""
    rng = np.random.default_rng([seed & (2**63 - 1), idx, 0x70726f6d])
    return rng.integers(0, vocab, size=length, dtype=np.int32)
