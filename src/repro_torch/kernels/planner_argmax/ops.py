"""Wrappers of the planner's kernels (K5, ``csrc/planner_argmax.cu``).

``masked_argmax``: the masked first maximum (first maximum among
masked-in entries, (-1, -inf) on an empty mask; see ref.py), for one (S,)
row or a batch of (N, S) rows whose values may share one column (row
stride 0), the direct counterpart of the TPU kernel. A CUDA tensor
launches the kernel on the current stream (no synchronize); a CPU tensor
runs ``masked_argmax_torch``. There is no fallback from one to the other.
Both are exact — comparisons only — so the choice never changes a
placement.

``plan_round``: a whole planning round of the greedy planner in one
launch, with that reduction inline (the kernel's header says how),
optionally gated by a request's latency mask. It takes CUDA tensors
only; its plain version is the planner's ``place_chunk`` +
``upgrade_chunk`` (core/planner/kernels.py), which
``core.planner.kernels.plan_round`` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

NAME = "planner_argmax"
# the ROADMAP entry of this kernel's backward, named when a launch under
# grad is refused (``_build.refuse_grad``)
GRAD_ITEM = ("ROADMAP Queue 2, 'Backward kernels': "
             "not queued: nothing differentiates the planner")

# launches of either K5 kernel, of the round kernel alone, and of the
# round kernel with a latency mask, since the last reset; read and reset
# by chip_smoke.py
LAUNCHES = 0
ROUND_LAUNCHES = 0
MASKED_LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.float64: 2}
MAX_RESOURCES = 4            # the round kernel's MAXR


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_masked_argmax
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 4 + [_I] * 2 + [_L] * 2 + [_I, _P]
    return fn


def masked_argmax_torch(values: torch.Tensor, mask: torch.Tensor):
    """Plain version over the last axis: a max-reduce, then the first
    index attaining it as a min over iota (``torch.argmax`` takes no
    bool, and this is the formulation of the JAX package's
    ``masked_argmax_jnp``). The ``mask &`` term keeps an empty mask on
    the (-1, -inf) contract."""
    n = values.shape[-1]
    neg = float("-inf")
    masked = torch.where(mask, values, neg)
    mx = masked.amax(-1)
    iota = torch.arange(n, dtype=torch.int32, device=values.device)
    i = torch.where(mask & (masked == mx.unsqueeze(-1)), iota, n).amin(-1)
    found = i < n
    return torch.where(found, i, -1), torch.where(found, mx, neg)


def _check(values, mask):
    if values.dim() not in (1, 2) or tuple(mask.shape) != \
            tuple(values.shape):
        raise ValueError(f"want values and mask of one shape, (S,) or "
                         f"(N, S); got {tuple(values.shape)}, "
                         f"{tuple(mask.shape)}")
    if values.shape[-1] < 1:
        raise ValueError("want S >= 1")
    if values.dtype not in _DTYPES:
        raise TypeError(f"want float32 or float64 values; got "
                        f"{values.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"want a bool mask; got {mask.dtype}")
    if mask.device != values.device:
        raise ValueError("values and mask must be on one device")


def masked_argmax(values: torch.Tensor, mask: torch.Tensor):
    """values (S,) or (N, S) float32/float64, mask bool of that shape ->
    (idx int32, val in the values' dtype), 0-dim or (N,): the first
    maximum of ``values`` where ``mask`` is set, per row; (-1, -inf)
    where the row's mask is empty."""
    global LAUNCHES
    _check(values, mask)
    if values.device.type == "cpu":
        return masked_argmax_torch(values, mask)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    _build.refuse_grad("K5 (masked argmax)", GRAD_ITEM, values)
    one = values.dim() == 1
    v2 = values.unsqueeze(0) if one else values
    m2 = mask.unsqueeze(0) if one else mask
    if v2.stride(1) != 1 or m2.stride(1) != 1:
        raise ValueError("values and mask need a unit stride along S")
    N, S = v2.shape
    idx = torch.empty(N, dtype=torch.int32, device=values.device)
    val = torch.empty(N, dtype=values.dtype, device=values.device)
    fn = _lib()
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = fn(v2.data_ptr(), m2.data_ptr(), idx.data_ptr(), val.data_ptr(),
             N, S, v2.stride(0), m2.stride(0), _DTYPES[values.dtype],
             stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    if one:
        return idx[0], val[0]
    return idx, val


def _round_lib():
    lib = _build.load(NAME)
    fn = lib.faillite_plan_round
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 14 + [_I] * 5 + [_P]
    return fn


def plan_round(free, head, budget, cap, alive, excl_off, excl_row, dm,
               dmc, start, stop, lat=None):
    """One planning round on the card (Algorithm 1, Lines 7-14) for A apps
    in placement order, in one launch; free (S, R), head (S,) in the state
    dtype and budget (R,) f64 are updated in place.

    cap (S, R) state dtype; alive (S,) bool; excl_off int32 (A + 1) and
    excl_row int32: each app's excluded server rows, as CSR; dm (A, V, R)
    f64 demands and dmc (A, V, R) state-dtype feasibility thresholds;
    start/stop int32 (A,): the variants app i may try; lat (A, V, S) uint8
    or bool, or None: the latency mask, variant j of app i allowed on
    server row s where ``lat[i, j, s]`` is set (None: every pair).
    Returns int32 (3, A) on the card: the placed variant relative to
    start (stop - start when unplaced), the server row (-1 when unplaced)
    and the upgraded variant (-1 for none)."""
    global LAUNCHES, ROUND_LAUNCHES, MASKED_LAUNCHES
    st = free.dtype
    if st not in _DTYPES:
        raise TypeError(f"want a float32 or float64 state; got {st}")
    S, R = free.shape
    A, V = dm.shape[:2]
    if not 1 <= R <= MAX_RESOURCES:
        raise ValueError(f"want 1..{MAX_RESOURCES} resources; got {R}")
    want = {"free": (free, st, (S, R)), "head": (head, st, (S,)),
            "budget": (budget, torch.float64, (R,)),
            "cap": (cap, st, (S, R)), "alive": (alive, torch.bool, (S,)),
            "excl_off": (excl_off, torch.int32, (A + 1,)),
            "excl_row": (excl_row, torch.int32, (excl_row.numel(),)),
            "dm": (dm, torch.float64, (A, V, R)),
            "dmc": (dmc, st, (A, V, R)),
            "start": (start, torch.int32, (A,)),
            "stop": (stop, torch.int32, (A,))}
    if lat is not None:
        if lat.dtype not in (torch.uint8, torch.bool):
            raise ValueError(f"lat must be uint8 or bool; got {lat.dtype}")
        if V * S >= 2**31:       # the kernel indexes an app's mask by int
            raise ValueError(f"lat: V * S = {V * S} must be below 2**31")
        want["lat"] = (lat, lat.dtype, (A, V, S))
    for name, (t, dt, shape) in want.items():
        if t.device.type != "cuda" or t.device != free.device:
            raise ValueError(f"plan_round takes tensors on one CUDA device; "
                             f"{name} is on {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} {shape}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    _build.refuse_grad("K5 (planning round)", GRAD_ITEM, free, head,
                       budget, cap, dm, dmc)
    out = torch.empty((3, A), dtype=torch.int32, device=free.device)
    stamp = torch.empty(S, dtype=torch.int32, device=free.device)
    fn = _round_lib()
    stream = torch.cuda.current_stream(free.device).cuda_stream
    err = fn(free.data_ptr(), head.data_ptr(), budget.data_ptr(),
             cap.data_ptr(), alive.data_ptr(), excl_off.data_ptr(),
             excl_row.data_ptr(), dm.data_ptr(), dmc.data_ptr(),
             start.data_ptr(), stop.data_ptr(),
             None if lat is None else lat.data_ptr(), out.data_ptr(),
             stamp.data_ptr(), A, S, V, R, _DTYPES[st], stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
        ROUND_LAUNCHES += 1
        MASKED_LAUNCHES += lat is not None
    return out


__all__ = ["masked_argmax", "masked_argmax_torch", "plan_round"]
