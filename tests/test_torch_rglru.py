"""The port's RG-LRU (K3 and ``models/rglru.py``) against the JAX package.

K3's plain version (what the wrapper runs on a CPU tensor) is held
against the Pallas kernel in interpret mode and against its oracle
``rglru_scan_ref`` on the sweep of tests/test_kernels.py, at that test's
1e-5. The gates, the carried causal conv and the recurrent block (prefill
from a state, then decode steps) are held against ``repro.models.rglru``
at 2e-4, the fp32 model tolerance of test_archs.py. K3 against its plain
version runs only on the card, in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.rglru_scan.ops import rglru_scan as pallas_rglru  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

SCAN_SWEEP = [                      # tests/test_kernels.py:64-68
    (2, 100, 256, 32, 128),
    (1, 64, 128, 64, 128),
    (3, 17, 256, 8, 256),
]
SCAN_ATOL = 1e-5
MODEL_ATOL = 2e-4
ARCH = "recurrentgemma-2b"


def _scan_inputs(seed, B, S, W):
    r = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-r.standard_normal((B, S, W))))) * 0.2 + 0.8
    b = r.standard_normal((B, S, W)) * 0.1
    h0 = r.standard_normal((B, W))
    return [x.astype(np.float32) for x in (a, b, h0)]


def _err(a_jax, b_torch):
    a = np.asarray(a_jax, np.float32)
    b = b_torch.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("B,S,W,bs,bw", SCAN_SWEEP)
def test_scan_plain_matches_pallas_and_ref(B, S, W, bs, bw):
    a, b, h0 = _scan_inputs(0, B, S, W)
    h_pal, hl_pal = pallas_rglru(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h0), block_s=bs, block_w=bw,
                                 interpret=True)
    h_ref, hl_ref = jax_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    h, hl = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(h0))
    for want_h, want_l in ((h_pal, hl_pal), (h_ref, hl_ref)):
        assert _err(want_h, h) < SCAN_ATOL
        assert _err(want_l, hl) < SCAN_ATOL
    # the wrapper's CPU path is the plain version; h_last may alias h0
    state = torch.from_numpy(h0.copy())
    hw, lw = rglru_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  state, h_last=state)
    assert lw is state
    assert torch.equal(hw, h) and torch.equal(state, hl)


def test_scan_wrapper_rejects_bad_input():
    a = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(a, a[:, :4], torch.zeros(2, 8))
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(a, a, torch.zeros(2, 7))
    with pytest.raises(TypeError):
        rglru_ops.rglru_scan(a.double(), a.double(), torch.zeros(2, 8))


@pytest.fixture(scope="module")
def rec_params():
    cj, ct = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    pj = JR.init_rglru(jax.random.PRNGKey(0), cj)
    # a trained conv bias is not zero; give it numbers so it is exercised
    pj["conv_b"] = jnp.asarray(np.random.default_rng(9).standard_normal(
        pj["conv_b"].shape).astype(np.float32) * 0.1)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    return cj, ct, pj, pt


def _state(seed, cfg, B):
    r = np.random.default_rng(seed)
    w = cfg.rnn_width
    return {"h": r.standard_normal((B, w)).astype(np.float32),
            "conv": r.standard_normal((B, cfg.conv1d_width - 1, w))
            .astype(np.float32)}


def test_gates_match_jax(rec_params):
    cj, ct, pj, pt = rec_params
    xb = np.random.default_rng(1).standard_normal(
        (2, 9, ct.rnn_width)).astype(np.float32)
    aj, bj = JR._gates(pj, cj, jnp.asarray(xb))
    at, bt = TR._gates(pt, ct, torch.from_numpy(xb))
    assert _err(aj, at) < MODEL_ATOL and _err(bj, bt) < MODEL_ATOL
    # the decode step is the scan at S = 1 (K3 on the card)
    hj = JR.rglru_step(pj, cj, jnp.asarray(xb[:, 0]),
                       jnp.asarray(xb[:, 1]))
    ht, hl = TR.rglru_scan(pt, ct, torch.from_numpy(xb[:, :1]),
                           torch.from_numpy(xb[:, 1]))
    assert _err(hj, ht[:, 0]) < MODEL_ATOL and _err(hj, hl) < MODEL_ATOL


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_jax(rec_params, carried):
    cj, ct, pj, pt = rec_params
    x = np.random.default_rng(2).standard_normal(
        (2, 7, ct.rnn_width)).astype(np.float32)
    tail = _state(3, ct, 2)["conv"] if carried else None
    yj, tj = JR.causal_conv1d(pj, jnp.asarray(x),
                              None if tail is None else jnp.asarray(tail))
    yt, tt = TR.causal_conv1d(pt, torch.from_numpy(x),
                              None if tail is None else
                              torch.from_numpy(tail))
    assert _err(yj, yt) < MODEL_ATOL and _err(tj, tt) < MODEL_ATOL


def test_recurrent_block_with_state_matches_jax(rec_params):
    """Prefill from a carried state, then decode steps (the block at
    S = 1, against JAX's ``recurrent_block_step``), the state updated in
    place by the port and returned anew by JAX."""
    cj, ct, pj, pt = rec_params
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 11, ct.d_model)).astype(np.float32)
    st = _state(5, ct, 2)
    sj = {k: jnp.asarray(v) for k, v in st.items()}
    stt = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    h_buf = stt["h"]
    oj, sj = JR.recurrent_block(pj, cj, jnp.asarray(x[:, :8]), sj)
    ot, stt2 = TR.recurrent_block(pt, ct, torch.from_numpy(x[:, :8]), stt)
    assert stt2 is stt and stt["h"] is h_buf          # updated in place
    assert _err(oj, ot) < MODEL_ATOL
    for t in range(8, 11):
        # the served decode step: the block at S = 1
        oj, sj = JR.recurrent_block_step(pj, cj, jnp.asarray(x[:, t]), sj)
        ot, stt = TR.recurrent_block(pt, ct, torch.from_numpy(x[:, t:t + 1]),
                                     stt)
        assert _err(oj, ot[:, 0]) < MODEL_ATOL
    for k in ("h", "conv"):
        assert _err(sj[k], stt[k]) < MODEL_ATOL
    # from no state: zeros, and a new state returned
    oj, sj = JR.recurrent_block(pj, cj, jnp.asarray(x), None)
    ot, st_new = TR.recurrent_block(pt, ct, torch.from_numpy(x), None)
    assert _err(oj, ot) < MODEL_ATOL and _err(sj["h"], st_new["h"]) \
        < MODEL_ATOL


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; exact gelu is off by ~4e-4,
    more than the model tolerance."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    assert _err(want, got) < 1e-6
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _err(want, exact) > MODEL_ATOL
