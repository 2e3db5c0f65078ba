"""Numpy reference for the masked-argmax reduction (tie rule oracle).

A copy of ``repro/kernels/planner_argmax/ref.py`` (the port imports
nothing from ``repro``). This is literally the planner's selection rule
(state.py / vectorized.py): `np.argmax` over the masked column returns
the FIRST maximum in ascending row order. The CUDA kernel and its plain
PyTorch version (ops.py) are both held bit-identical to this, including
ties and the empty-mask case."""

from __future__ import annotations

import numpy as np


def masked_argmax_ref(values, mask):
    """(S,) values + (S,) bool mask -> (idx, val); (-1, -inf) when the
    mask admits nothing. Values must be finite: -inf is reserved as
    the mask sentinel (the planner only ever reduces normalized
    headroom, which is finite)."""
    values = np.asarray(values)
    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return -1, float("-inf")
    masked = np.where(mask, values, -np.inf)
    i = int(np.argmax(masked))
    return i, masked[i]
