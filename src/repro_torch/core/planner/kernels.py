"""The planner's inner loops on device tensors (the ``torch`` backend).

The port of ``repro/core/planner/kernels.py``. A planning round is
``plan_round``: on the card, one launch of K5's round kernel
(``kernels/planner_argmax``, ``plan_round``), which runs Algorithm 1's
Lines 7-14 for every app of the round with the masked-argmax reduction
inline; on the CPU, its plain version ``plan_round_plain``, which is
these primitives, each a sequence of PyTorch operations on the tensors
of a `DeviceMirror` (planner/torch_backend.py), with K5's masked argmax
as the worst-fit reduction:

  * ``place_chunk`` — Algorithm 1's degradation loop (Lines 7-12) and
    worst-fit (Line 9) for a round's apps, in placement order,
    against the working (S, R) free / (S,) headroom / (R,) α-budget;
  * ``upgrade_chunk`` — the upgrade pass (Lines 13-14), with the legacy
    give-then-take two-step replayed op for op;
  * ``scatter_rows`` — the dirty-row update of the device mirror.

A request's latency mask (``lat``, (A, V, S) over global server rows)
gates both passes: a (variant, server) pair over the app's SLO is
neither a placement nor an upgrade candidate, as in numpy.

Bit-exactness contract (tests/test_torch_planner.py holds every result
against numpy's ``vectorized.plan_greedy``): every arithmetic operation
is the same IEEE operation in the same dtype and order as the numpy
path. The (S, R) feasibility compare runs in the state dtype against the
round-up thresholds of ``torch_backend._cmp_thresholds``; in-place
updates of an f32 state replay numpy's compute-in-f64-then-cast with
explicit ``.to(torch.float64)`` / ``.to(state dtype)`` (a 0-dim f64
tensor would not promote an f32 one in torch); every argmax keeps the
first-maximum rule. The round kernel does the same operations (its
header says how).

The degradation loop tests variants ``start..`` in order and stops at
the first one that passes the α-budget and has a feasible server.
Nothing changes between those tries, so ``place_chunk`` computes every
candidate variant's worst-fit server in one K5 launch over a (V, S)
feasibility matrix, the shared headroom column broadcast with a row
stride of 0, and takes the first variant that succeeds: the same
variant and server, with no host round trip per app.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.planner_argmax import ops as k5
from repro_torch.kernels.planner_argmax.ops import masked_argmax

_EPS = 1e-9


def resolve_backend(backend: str) -> str:
    """Validate a planner backend name at construction time, so a bad
    config fails loudly instead of at the first failover round."""
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown planner backend {backend!r}; "
                         "expected 'numpy' or 'torch'")
    return backend


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a one-element index tensor) of ``t``, as a (1, ...)
    tensor, without reading ``i`` on the host."""
    return t.index_select(0, i)


def place_chunk(free: torch.Tensor, head: torch.Tensor,
                budget: torch.Tensor, cap: torch.Tensor,
                allowed: torch.Tensor, dm: torch.Tensor, dmc: torch.Tensor,
                start: Sequence[int], stop: Sequence[int], lat=None):
    """Lines 7-12 for ``n`` apps in placement order.

    free (S, R) and head (S,) in the state dtype and budget (R,) f64 are
    updated in place; cap (S, R) is the capacity. allowed (n, S) bool:
    alive and not excluded. dm (n, V, R) f64: variant demands; dmc
    (n, V, R): the feasibility thresholds in the state dtype. start/stop
    (host ints): the variants app i may try, ``start[i] <= j < stop[i]``.
    lat (n, V, S) bool or None: variant j may go to server s only where
    ``lat[i, j, s]`` is set.

    Returns (j, k), int32 (n,) on the device: the variant index relative
    to ``start[i]`` and the server row. App i is placed iff
    ``j[i] < stop[i] - start[i]``; k is meaningful only then.
    """
    n = len(start)
    dev, st, f64 = free.device, free.dtype, torch.float64
    S = head.shape[0]
    V = dm.shape[1]
    dme = dm - _EPS                        # the α-budget test's d - eps
    iota = torch.arange(V, dtype=torch.int32, device=dev)
    j_out = torch.empty(n, dtype=torch.int32, device=dev)
    k_out = torch.empty(n, dtype=torch.int32, device=dev)
    for i in range(n):
        a, b = int(start[i]), int(stop[i])
        nv = b - a
        # every candidate variant's feasibility column, compared in the
        # state dtype against the precomputed thresholds, and its
        # worst-fit server (first maximum of headroom): one K5 launch
        feas = (free[None] >= dmc[i, a:b, None, :]).all(-1) & allowed[i]
        if lat is not None:
            feas &= lat[i, a:b]
        kj, _ = masked_argmax(head.expand(nv, S), feas)
        bok = (budget >= dme[i, a:b]).all(-1)
        jj = torch.where(bok & (kj >= 0), iota[:nv], nv).amin()
        placed = jj < nv
        jc = jj.clamp(max=nv - 1).view(1).long()
        k = kj.index_select(0, jc)
        ku = torch.where(placed, k, 0).long()
        d = dm[i, a:b].index_select(0, jc)[0]
        row = _row(free, ku)
        # numpy's in-place `free[k] -= d` computes in f64, casts back
        newrow = (row.to(f64) - d).to(st)
        free.index_put_((ku,), torch.where(placed, newrow, row))
        budget.copy_(torch.where(placed, budget - d, budget))
        newhead = (_row(free, ku) / _row(cap, ku)).amin()
        head.index_put_((ku,), torch.where(placed, newhead,
                                           _row(head, ku)))
        j_out[i] = jj
        k_out[i] = k[0]
    return j_out, k_out


def upgrade_chunk(free: torch.Tensor, head: torch.Tensor,
                  budget: torch.Tensor, cap: torch.Tensor,
                  dm: torch.Tensor, jcur: Sequence[int],
                  k: Sequence[int], lat=None) -> torch.Tensor:
    """Lines 13-14 for ``n`` apps in placement order, after every app of
    the round has been placed: app i, placed on row ``k[i]`` with variant
    ``jcur[i]`` (host ints; k < 0 = unplaced), moves to the first larger
    variant j < jcur whose extra demand fits its row and the α-budget
    (and, with a latency mask ``lat`` (n, V, S) bool, is allowed on that
    row). free/head/budget are updated in place.

    Returns j_up, int32 (n,) on the device: the new variant, or -1.
    """
    n = len(jcur)
    dev, st, f64 = free.device, free.dtype, torch.float64
    V = dm.shape[1]
    iota = torch.arange(V, dtype=torch.int32, device=dev)
    up = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for i in range(n):
        jc, kk = int(jcur[i]), int(k[i])
        if kk < 0 or jc <= 0:
            continue
        d_cur = dm[i, jc]
        extras = dm[i, :jc] - d_cur                       # f64 exact
        ext_e = extras - _EPS
        row = free[kk]
        row64 = row.to(f64)
        ok = (row64 >= ext_e).all(-1) & (budget >= ext_e).all(-1)
        if lat is not None:
            ok &= lat[i, :jc, kk]
        ju = torch.where(ok, iota[:jc], jc).amin()
        take = ju < jc
        d_up = dm[i].index_select(0, ju.clamp(max=jc - 1).view(1).long())[0]
        # give(current) then take(upgrade), two casts, NOT one fused
        # delta — replays the legacy float rounding exactly
        row1 = (row64 + d_cur).to(st)
        row2 = (row1.to(f64) - d_up).to(st)
        free[kk] = torch.where(take, row2, row)
        budget.copy_(torch.where(take, (budget + d_cur) - d_up, budget))
        head[kk] = torch.where(take, (free[kk] / cap[kk]).amin(), head[kk])
        up[i] = torch.where(take, ju, -1)
    return up


def dense_allowed(alive: torch.Tensor, excl_off: torch.Tensor,
                  excl_row: torch.Tensor) -> torch.Tensor:
    """(A, S) bool: ``alive`` with each app's excluded rows cleared, from
    the CSR form (``excl_off`` (A + 1) offsets into ``excl_row``)."""
    A = excl_off.numel() - 1
    allowed = alive.repeat(A, 1)
    app = torch.repeat_interleave(
        torch.arange(A, device=alive.device),
        (excl_off[1:] - excl_off[:-1]).long())
    allowed[app, excl_row.long()] = False
    return allowed


def plan_round_plain(free, head, budget, cap, alive, excl_off, excl_row,
                     dm, dmc, start, stop, lat=None) -> torch.Tensor:
    """The plain version of K5's round kernel: ``place_chunk`` then
    ``upgrade_chunk`` over the dense ``allowed`` of the CSR exclusions.
    Same arguments, updates and (3, A) int32 result as
    ``kernels.planner_argmax.ops.plan_round``."""
    a, b = start.tolist(), stop.tolist()
    if lat is not None:
        lat = lat.bool()
    j, k = place_chunk(free, head, budget, cap,
                       dense_allowed(alive, excl_off, excl_row), dm, dmc,
                       a, b, lat)
    jr, kr = torch.stack([j, k]).tolist()
    placed = [x < s1 - s0 for x, s0, s1 in zip(jr, a, b)]
    jc = [x + s0 if p else -1 for x, s0, p in zip(jr, a, placed)]
    kp = [x if p else -1 for x, p in zip(kr, placed)]
    up = upgrade_chunk(free, head, budget, cap, dm, jc, kp, lat)
    return torch.stack([j, torch.tensor(kp, dtype=torch.int32,
                                        device=j.device), up])


def plan_round(free, head, budget, cap, alive, excl_off, excl_row, dm,
               dmc, start, stop, lat=None) -> torch.Tensor:
    """One planning round (Lines 7-14) for A apps in placement order:
    K5's round kernel on the card, ``plan_round_plain`` on the CPU; free,
    head and budget are updated in place. See
    ``kernels.planner_argmax.ops.plan_round`` for the arguments (``lat``:
    the optional (A, V, S) latency mask) and the (3, A) int32 result
    (variant relative to start, server row, upgraded variant)."""
    args = (free, head, budget, cap, alive, excl_off, excl_row, dm, dmc,
            start, stop, lat)
    if free.device.type == "cuda":
        return k5.plan_round(*args)
    return plan_round_plain(*args)


def scatter_rows(free: torch.Tensor, head: torch.Tensor,
                 alive: torch.Tensor, idx: torch.Tensor,
                 frows: torch.Tensor, hrows: torch.Tensor,
                 arows: torch.Tensor) -> None:
    """Write the given rows of the device mirror in place. ``idx`` holds
    row indices < S only: unlike JAX's ``mode="drop"``, ``index_put_``
    raises on an index past the end, so callers pass no padding."""
    free.index_put_((idx,), frows)
    head.index_put_((idx,), hrows)
    alive.index_put_((idx,), arows)


__all__ = ["dense_allowed", "place_chunk", "plan_round", "plan_round_plain",
           "resolve_backend", "scatter_rows", "upgrade_chunk"]
