"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

Takes the model's layout: q (B, 1, H, hd) against the slot cache
(B, Smax, KVH, hd), read in place. A CUDA tensor launches the kernel on
the current stream (no synchronize); a CPU tensor runs the plain version
in ``ref.py``. There is no fallback from one to the other.

On the card a call is split-KV: ``plan_split`` cuts the cache into
fixed chunks from the shapes and the card's SM count alone (never from
``lens``, so a decode step needs no host sync), one kernel writes each
chunk's partial softmax into fp32 workspaces allocated here, and a second
merges them in fixed order. A small cache is one chunk, and then the one
kernel writes the output itself. ``LAUNCHES`` counts wrapper calls, one per
layer per decode step, whatever the number of kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

NAME = "decode_attention"
# the ROADMAP entry of this kernel's backward, named when a launch under
# grad is refused (``_build.refuse_grad``)
GRAD_ITEM = ("ROADMAP Queue 2, 'Backward kernels': "
             "not queued: no train step decodes")
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 32                     # one warp per query head of a group
TILE_KEYS = 32                     # keys per tile of the split kernel
SPLIT_MIN_TILES = 4                # caches of up to this many tiles run
                                   # as one chunk: no combine
DTYPES = _build.DTYPE_CODES

# kernel launches since the last reset; read and reset by chip_smoke.py
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_decode_attention
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = ([_P] * 8 + [_I] * 8 + [_L] * 10 + [_I, _P])
    return fn


def plan_split(B, KVH, Smax, n_sm):
    """(n_split, chunk) of the split-KV launch: chunk s covers the key
    positions [s * chunk, (s + 1) * chunk), chunk a multiple of
    ``TILE_KEYS``, every chunk non-empty. A cache of at most
    ``SPLIT_MIN_TILES`` tiles is one chunk: a block walks it in about the
    time of the combine's launch, so a split cannot pay for it. Above
    that, aims at one to two waves of blocks, (n_split, KVH, B) >=
    min(n_sm, B * KVH * tiles) and below 2 * n_sm + B * KVH; depends on
    these four numbers only."""
    tiles = -(-Smax // TILE_KEYS)
    if tiles <= SPLIT_MIN_TILES:
        return 1, tiles * TILE_KEYS
    want = -(-2 * n_sm // (B * KVH))
    per = -(-tiles // min(tiles, want))   # tiles a chunk
    chunk = per * TILE_KEYS
    return -(-Smax // chunk), chunk


def _check(q, k_cache, v_cache, lens, window):
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q (B,1,H,hd), caches (B,Smax,KVH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, _, H, hd = q.shape
    Bk, _, KVH, hdk = k_cache.shape
    if Bk != B or hdk != hd or KVH == 0 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} do not form GQA attention")
    if lens.shape != (B,):
        raise ValueError(f"lens must be ({B},), got {tuple(lens.shape)}")
    if not (q.device == k_cache.device == v_cache.device == lens.device):
        raise ValueError("q, caches and lens must be on one device")
    if q.dtype not in DTYPES or not (q.dtype == k_cache.dtype
                                     == v_cache.dtype):
        raise TypeError(f"want float32 or bfloat16 q/caches of one dtype; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def decode_attention(q, k_cache, v_cache, lens, *, window=0):
    """q: (B,1,H,hd); caches (B,Smax,KVH,hd); lens (B,) -> (B,1,H,hd)."""
    global LAUNCHES
    _check(q, k_cache, v_cache, lens, window)
    if q.device.type == "cpu":
        o = decode_attention_ref(q[:, 0], k_cache.transpose(1, 2),
                                 v_cache.transpose(1, 2), lens,
                                 window=window)
        return o[:, None]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _build.refuse_grad("K2 (decode attention)", GRAD_ITEM, q, k_cache,
                       v_cache)
    B, _, H, hd = q.shape
    _, Smax, KVH, _ = k_cache.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if H // KVH > MAX_GROUP:
        raise ValueError(f"GQA group {H // KVH} > {MAX_GROUP}")
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise TypeError(f"lens must be contiguous int32, got {lens.dtype}")
    if any(t.stride(-1) != 1 or not _build.rows_aligned(t)
           for t in (q, k_cache, v_cache)):
        raise ValueError("q and caches need a unit stride on head_dim and "
                         "16-byte aligned rows")
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    n_split, chunk = plan_split(B, KVH, Smax, sm_count(q.device.index))
    G = H // KVH
    parts = [None] * 3
    if n_split > 1:
        acc = torch.empty((B, KVH, n_split, G, hd), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((2, B, KVH, n_split, G), dtype=torch.float32,
                         device=q.device)
        parts = [acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr()]
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lens.data_ptr(), out.data_ptr(), *parts, DTYPES[q.dtype],
             B, H, KVH, Smax, hd, n_split, chunk,
             q.stride(0), q.stride(2),
             *k_cache.stride()[:3], *v_cache.stride()[:3],
             out.stride(0), out.stride(2), int(window), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return out
