"""Wrapper of the weight-only int8 matmul kernel (K6,
``csrc/int8_matmul.cu``), its plain PyTorch version, and the quantizer.

``int8_matmul(x, w_q, scale)`` computes ``(x @ w_q) * scale`` with an
fp32 sum: x (M, K) float32 or bfloat16, w_q (K, N) int8, scale (N,)
float32 per output channel, out (M, N) in ``out_dtype`` (x's by
default). A CUDA tensor launches the kernel on the current stream (no
synchronize); a CPU tensor runs ``int8_matmul_torch``. There is no
fallback from one to the other.

On the card a bf16 x runs on the tensor cores; where the output tiles
leave the card idle (always at decode, M <= 16) ``plan_splitk`` cuts K
into ranges from the shapes and the card's SM count alone, one kernel
writes each range's fp32 partial sums into a workspace allocated here,
and a second adds them in fixed order.
``LAUNCHES`` counts wrapper calls, whatever the number of kernels.

As in the JAX package, no model or serving path calls it: the ladder's
``:int8`` rungs only price their bytes (``ModelConfig.quant_bits``). It
is a standalone kernel with its own tests.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

NAME = "int8_matmul"
# the ROADMAP entry of this kernel's backward, named when a launch under
# grad is refused (``_build.refuse_grad``)
GRAD_ITEM = ("ROADMAP Queue 2, 'Backward kernels': "
             "not queued: no model calls K6")
DTYPES = _build.DTYPE_CODES
# the bf16 kernel's tiles (csrc TcDecode, TcPrefill): (rows, columns) a
# block at decode (M <= DECODE_M) and above
DECODE_M = 16
DECODE_TILE = (16, 128)
PREFILL_TILE = (64, 128)
TILE_K = 32           # K a stage; a split's K range is a multiple
SPLIT_WAVES = 4       # blocks per SM a split aims at
MIN_SPLIT_STEPS = 8   # K stages a split walks at least

# kernel launches since the last reset; read and reset by chip_smoke.py
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_int8_matmul
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 5 + [_I] * 7 + [_L, _P]
    return fn


def plan_splitk(M, N, K, n_sm):
    """(n_split, k_chunk) of a bf16 launch: split s covers the K range
    [s * k_chunk, (s + 1) * k_chunk), k_chunk a multiple of ``TILE_K``,
    every range non-empty. Where the output tiles alone leave the card
    idle (decode's single row tile; a narrow N at prefill), K is split
    until the blocks reach ``SPLIT_WAVES`` per SM, each range at least
    ``MIN_SPLIT_STEPS`` stages long; depends on these four numbers
    only."""
    bm, bn = DECODE_TILE if M <= DECODE_M else PREFILL_TILE
    steps = -(-K // TILE_K)
    tiles = -(-M // bm) * -(-N // bn)
    n = max(1, min(-(-SPLIT_WAVES * n_sm // tiles), steps // MIN_SPLIT_STEPS))
    chunk = -(-steps // n) * TILE_K
    return -(-K // chunk), chunk


def quantize_int8(w, axis=0):
    """Symmetric per-channel int8 quantization along ``axis`` (the
    contraction axis), as ``repro.kernels.int8_matmul.quantize_int8``:
    the same fp32 arithmetic, round half to even, clip to +-127 and a
    1e-8 floor on the scale. Returns (w_q int8 (K,N), scale f32 (N,))
    with w ~= w_q * scale."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127)
    return w_q.to(torch.int8), scale.reshape(-1)


def int8_matmul_torch(x, w_q, scale, *, out_dtype=None):
    """The plain version: ``(x.float() @ w_q.float()) * scale``, cast to
    the output dtype."""
    return int8_matmul_ref(x, w_q, scale, out_dtype=out_dtype)


def _check(x, w_q, scale, out_dtype):
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"want x (M,K), w_q (K,N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    M, K = x.shape
    Kw, N = w_q.shape
    if Kw != K or scale.shape[0] != N or 0 in (M, K, N):
        raise ValueError(f"x {tuple(x.shape)}, w_q {tuple(w_q.shape)} and "
                         f"scale {tuple(scale.shape)} do not chain")
    if not (x.device == w_q.device == scale.device):
        raise ValueError("x, w_q and scale must be on one device")
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"want float32 or bfloat16 x and output; got "
                        f"{x.dtype}, {out_dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"want int8 w_q and float32 scale; got {w_q.dtype}, "
                        f"{scale.dtype}")


def int8_matmul(x, w_q, scale, *, out_dtype=None):
    """x: (M,K); w_q: (K,N) int8; scale: (N,) float32 -> (M,N)."""
    global LAUNCHES
    out_dtype = out_dtype or x.dtype
    _check(x, w_q, scale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_torch(x, w_q, scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _build.refuse_grad("K6 (int8 matmul)", GRAD_ITEM, x, scale)
    if x.stride(1) != 1 or not w_q.is_contiguous() \
            or not scale.is_contiguous():
        raise ValueError("x needs a unit column stride, w_q and scale must "
                         "be contiguous")
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    n_split, chunk = 1, -(-K // TILE_K) * TILE_K
    if x.dtype == torch.bfloat16:
        n_split, chunk = plan_splitk(M, N, K, sm_count(x.device.index))
    ws = None
    if n_split > 1:
        ws = torch.empty((n_split, M, N), dtype=torch.float32,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 DTYPES[x.dtype], DTYPES[out_dtype], M, N, K, n_split, chunk,
                 x.stride(0), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return out
