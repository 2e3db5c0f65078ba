"""K3's gated route and chunked scan, on the CPU, against the JAX package.

The gated route's plain version (``rglru_gated_scan_ref``: the elementwise
tail of the gates, then the sequential scan; what the wrapper runs on a
CPU tensor) is held against JAX's ``repro.models.rglru`` ``_gates`` +
``rglru_scan`` (the associative scan) on the same gate products, and
against the Pallas kernel in interpret mode fed JAX's a and b: the sweep
of tests/test_kernels.py, f32 and bf16 gate inputs, zero and carried
state, at 2e-4 (the fp32 model tolerance of tests/test_torch_rglru.py).
The model's scan on a CPU tensor is bit-equal to ``_gates`` followed by
``rglru_scan_ref``, the path it replaced.

``rglru_scan_chunked_ref`` is the CUDA kernel's prefill algorithm (chunks
scanned from zero, carries combined in chunk order, each chunk rescanned
from its carry-in). It is held against ``rglru_scan_pallas(interpret=True)``
and the sequential ref at 1e-5 (tests/test_kernels.py:77-78), with S no
multiple of the chunk, S shorter than it and S = 1; its first chunk is
the sequential scan bit for bit. K3 on the card against these versions is
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.rglru_scan.ops import rglru_scan as pallas_rglru  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as K3  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

SCAN_SWEEP = [                      # tests/test_kernels.py:64-68
    (2, 100, 256, 32, 128),
    (1, 64, 128, 64, 128),
    (3, 17, 256, 8, 256),
]
SCAN_ATOL = 1e-5
MODEL_ATOL = 2e-4
ARCH = "recurrentgemma-2b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _err(a_jax, b_torch):
    a = np.asarray(jnp.asarray(a_jax, jnp.float32))
    b = b_torch.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _t(a):
    """A JAX array as a torch tensor of the same dtype and values."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _layer(W, dtype, seed):
    """JAX RG-LRU params of width W in ``dtype`` and their port copy."""
    cj = jconfigs.get_smoke(ARCH).replace(rnn_width=W, param_dtype=dtype,
                                          activation_dtype=dtype)
    ct = tconfigs.get_smoke(ARCH).replace(rnn_width=W, param_dtype=dtype,
                                          activation_dtype=dtype)
    pj = JR.init_rglru(jax.random.PRNGKey(seed), cj)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W,bs,bw", SCAN_SWEEP)
def test_gated_plain_matches_jax_gates_and_scan(B, S, W, bs, bw, dtype,
                                                carried):
    cj, ct, pj, pt = _layer(W, dtype, seed=S)
    r = np.random.default_rng(S + W)
    xj = jnp.asarray(r.standard_normal((B, S, W)).astype(np.float32),
                     JDT[dtype])
    h0 = r.standard_normal((B, W)).astype(np.float32) if carried else None
    h0j = None if h0 is None else jnp.asarray(h0)
    # the same gate products on both sides: JAX's block-diagonal einsums
    nb = cj.rnn_blocks
    ga = JR._block_gate(pj["gate_a"], xj, nb)
    gx = JR._block_gate(pj["gate_x"], xj, nb)
    h0t = torch.zeros(B, W) if h0 is None else torch.from_numpy(h0)
    h, hl = K3.rglru_gated_scan_ref(_t(ga), _t(gx), _t(xj),
                                    pt["log_lambda"], h0t)
    hj, hlj = JR.rglru_scan(pj, cj, xj, h0j)
    assert _err(hj, h) < MODEL_ATOL and _err(hlj, hl) < MODEL_ATOL
    # the Pallas kernel fed JAX's a and b (the carried state folded in as
    # the JAX model folds it: the kernel's own h0)
    aj, bj = JR._gates(pj, cj, xj)
    hp, hlp = pallas_rglru(aj, bj, jnp.asarray(h0t.numpy()), block_s=bs,
                           block_w=bw, interpret=True)
    assert _err(hp, h) < MODEL_ATOL and _err(hlp, hl) < MODEL_ATOL
    # the wrapper on a CPU tensor is the plain version, h_last may alias
    # h0, and nothing is launched
    n0 = rglru_ops.LAUNCHES, rglru_ops.GATED_LAUNCHES
    state = h0t.clone()
    hw, lw = rglru_ops.rglru_gated_scan(_t(ga), _t(gx), _t(xj),
                                        pt["log_lambda"], state,
                                        h_last=state)
    assert lw is state
    assert torch.equal(hw, h) and torch.equal(state, hl)
    assert (rglru_ops.LAUNCHES, rglru_ops.GATED_LAUNCHES) == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_scan_on_cpu_is_gates_then_sequential_scan(dtype):
    """The model's scan through the gated route gives, on the CPU, the bits
    of the path it replaced: ``_gates`` then ``rglru_scan_ref``."""
    _, ct, _, pt = _layer(64, dtype, seed=3)
    r = np.random.default_rng(4)
    xb = torch.from_numpy(r.standard_normal((2, 9, 64)).astype(
        np.float32)).to(TDT[dtype])
    h0 = torch.from_numpy(r.standard_normal((2, 64)).astype(np.float32))
    a, b = TR._gates(pt, ct, xb)
    for state in (None, h0):
        want = K3.rglru_scan_ref(a, b, torch.zeros(2, 64) if state is None
                                 else state)
        got = TR.rglru_scan(pt, ct, xb, state)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gated_wrapper_rejects_bad_input():
    x = torch.zeros(2, 5, 8)
    lam, h0 = torch.zeros(8), torch.zeros(2, 8)
    with pytest.raises(ValueError):
        rglru_ops.rglru_gated_scan(x, x[:, :4], x, lam, h0)
    with pytest.raises(ValueError):
        rglru_ops.rglru_gated_scan(x, x, x, lam[:7], h0)
    with pytest.raises(ValueError):
        rglru_ops.rglru_gated_scan(x, x, x, lam, h0[:, :7])
    with pytest.raises(TypeError):
        rglru_ops.rglru_gated_scan(x, x.bfloat16(), x, lam, h0)
    with pytest.raises(TypeError):
        rglru_ops.rglru_gated_scan(x.double(), x.double(), x.double(), lam,
                                   h0)
    with pytest.raises(TypeError):
        rglru_ops.rglru_gated_scan(x, x, x, lam.double(), h0)


def _scan_inputs(seed, B, S, W):
    r = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-r.standard_normal((B, S, W))))) * 0.2 + 0.8
    b = r.standard_normal((B, S, W)) * 0.1
    h0 = r.standard_normal((B, W))
    return [x.astype(np.float32) for x in (a, b, h0)]


# (B, S, W, chunk): the sweep at the kernel's chunk length; S no multiple
# of the chunk, shorter than it, S = 1, and the main path's 256 (chunk 8)
CHUNKED = [(B, S, W, None) for B, S, W, _, _ in SCAN_SWEEP] + [
    (2, 100, 256, 7), (1, 64, 128, 16), (2, 5, 64, 8), (3, 1, 128, None),
    (1, 1, 64, 4), (1, 256, 128, None), (1, 300, 64, None),
    (2, 33, 32, 32)]


@pytest.mark.parametrize("B,S,W,chunk", CHUNKED)
def test_chunked_emulation_matches_pallas_and_sequential(B, S, W, chunk):
    a, b, h0 = _scan_inputs(S + B, B, S, W)
    at, bt, h0t = (torch.from_numpy(x) for x in (a, b, h0))
    h, hl = K3.rglru_scan_chunked_ref(at, bt, h0t, chunk)
    hs, hls = K3.rglru_scan_ref(at, bt, h0t)
    assert float((h - hs).abs().max()) < SCAN_ATOL
    assert float((hl - hls).abs().max()) < SCAN_ATOL
    hp, hlp = pallas_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                           block_s=min(64, S), block_w=min(128, W),
                           interpret=True)
    assert _err(hp, h) < SCAN_ATOL and _err(hlp, hl) < SCAN_ATOL
    # chunk 0 starts from h0 itself: the sequential scan, bit for bit
    L = chunk or K3.chunk_len(S)
    assert torch.equal(h[:, :L], hs[:, :L])
    assert torch.equal(hl, h[:, -1])


def test_chunk_len_follows_from_s_alone():
    assert [K3.chunk_len(S) for S in (1, 2, 32, 33, 256, 257, 2100)] == \
        [1, 1, 1, 2, 8, 9, 66]
    for S in range(1, 700):
        L = K3.chunk_len(S)
        assert -(-S // L) <= K3.CHUNKS and (L == 1 or (L - 1) * K3.CHUNKS
                                            < S)
