"""The port's RWKV-6 (K4 and ``models/rwkv6.py``) against the JAX package.

K4 computes the recurrence the model states (``wkv_scan``), from the
slot's state and with no clamp on the log-decay. Its plain version (what
the wrapper runs on a CPU tensor) is held:

- against the Pallas kernel ``wkv6`` in interpret mode, on the sweep of
  tests/test_kernels.py with lw >= -40/chunk, where that kernel's
  stability clamp changes nothing;
- against ``wkv6_ref`` and the model's ``wkv_chunked``/``wkv_scan`` with
  lw down to -3, as rwkv6-3b's decay_base reaches, where the clamped
  kernel computes another function and the port must follow the model;
- from a nonzero initial state.

Tolerance 5e-4, that of tests/test_kernels.py for K4. ``time_mix`` and
``channel_mix`` with carried state are held against JAX at 5e-4 and 2e-4.
K4 against its plain version runs only on the card, in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.rwkv6_scan.ops import wkv6 as pallas_wkv6  # noqa: E402
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402

WKV_SWEEP = [                       # tests/test_kernels.py:82-86
    (2, 3, 70, 16, 16),
    (1, 2, 64, 32, 32),
    (2, 1, 33, 8, 8),
]
WKV_ATOL = 5e-4
TM_ATOL, CM_ATOL = 5e-4, 2e-4
ARCH = "rwkv6-3b"


def _wkv_inputs(seed, B, NH, S, hs, lw_min):
    """(B,S,nh,hs) inputs in the model's layout, and u (nh,hs). lw is
    spread over [lw_min, ~-0.05]."""
    r = np.random.default_rng(seed)
    rkv = [r.standard_normal((B, S, NH, hs)).astype(np.float32)
           for _ in range(3)]
    lw = -np.exp(r.uniform(np.log(0.05), np.log(-lw_min),
                           (B, S, NH, hs))).astype(np.float32)
    u = (r.standard_normal((NH, hs)) * 0.3).astype(np.float32)
    return rkv + [lw, u]


def _to_heads_first(t):
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(t, 1, 2)))


def _err(a_jax, b_torch):
    a = np.asarray(a_jax, np.float32)
    b = b_torch.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("B,NH,S,hs,chunk", WKV_SWEEP)
def test_plain_matches_pallas_where_the_clamp_is_idle(B, NH, S, hs, chunk):
    r, k, v, lw, u = _wkv_inputs(0, B, NH, S, hs, lw_min=-40.0 / chunk)
    y_pal, s_pal = pallas_wkv6(*map(_to_heads_first, (r, k, v, lw)),
                               jnp.asarray(u), chunk=chunk, interpret=True)
    s0 = torch.zeros((B, NH, hs, hs))
    y, s = wkv_ops.wkv6(*map(torch.from_numpy, (r, k, v, lw, u)), s0)
    assert _err(np.moveaxis(np.asarray(y_pal), 1, 2), y) < WKV_ATOL
    assert _err(s_pal, s) < WKV_ATOL


@pytest.mark.parametrize("B,NH,S,hs,chunk", WKV_SWEEP)
def test_plain_follows_the_model_below_the_clamp(B, NH, S, hs, chunk):
    """lw down to -3: the port agrees with wkv6_ref and the model's
    wkv_chunked/wkv_scan; the clamped TPU kernel does not."""
    r, k, v, lw, u = _wkv_inputs(1, B, NH, S, hs, lw_min=-3.0)
    args_t = list(map(torch.from_numpy, (r, k, v, lw, u)))
    y, s = wkv_ops.wkv6(*args_t, torch.zeros((B, NH, hs, hs)))
    y_ref, s_ref = jax_wkv6_ref(*map(_to_heads_first, (r, k, v, lw)),
                                jnp.asarray(u))
    assert _err(np.moveaxis(np.asarray(y_ref), 1, 2), y) < WKV_ATOL
    assert _err(s_ref, s) < WKV_ATOL
    args_j = list(map(jnp.asarray, (r, k, v, lw, u)))
    for fn in (JW.wkv_chunked, JW.wkv_scan):
        yj, sj = fn(*args_j)
        assert _err(yj, y) < WKV_ATOL and _err(sj, s) < WKV_ATOL
    y_pal, s_pal = pallas_wkv6(*map(_to_heads_first, (r, k, v, lw)),
                               jnp.asarray(u), chunk=chunk, interpret=True)
    if lw.min() < -40.0 / chunk:              # the clamp binds
        assert _err(s_pal, s) > 10 * WKV_ATOL
    else:
        assert _err(s_pal, s) < WKV_ATOL


@pytest.mark.parametrize("S", [1, 40, 64])
def test_nonzero_state_matches_model(S):
    B, NH, hs = 2, 3, 16
    r, k, v, lw, u = _wkv_inputs(2, B, NH, S, hs, lw_min=-3.0)
    s0 = np.random.default_rng(3).standard_normal(
        (B, NH, hs, hs)).astype(np.float32)
    state = torch.from_numpy(s0.copy())
    y, s = wkv_ops.wkv6(*map(torch.from_numpy, (r, k, v, lw, u)), state,
                        s_out=state)
    assert s is state
    args_j = list(map(jnp.asarray, (r, k, v, lw, u)))
    for fn in (JW.wkv_chunked, JW.wkv_scan):
        yj, sj = fn(*args_j, jnp.asarray(s0))
        assert _err(yj, y) < WKV_ATOL and _err(sj, state) < WKV_ATOL
    # the port's CPU form of the prefill, from the same state
    yc, sc = TW.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                            torch.from_numpy(s0))
    assert float((yc - y).abs().max()) < WKV_ATOL
    assert float((sc - state).abs().max()) < WKV_ATOL


def test_wkv_wrapper_rejects_bad_input():
    t = torch.zeros(1, 4, 2, 8)
    u = torch.zeros(2, 8)
    s0 = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError):
        wkv_ops.wkv6(t, t, t, t[:, :3], u, s0)
    with pytest.raises(ValueError):
        wkv_ops.wkv6(t, t, t, t, u[:1], s0)
    with pytest.raises(ValueError):
        wkv_ops.wkv6(t, t, t, t, u, s0[:, :1])
    with pytest.raises(TypeError):
        wkv_ops.wkv6(t, t, t, t.double(), u, s0)


@pytest.fixture(scope="module")
def mix_params():
    cj, ct = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pj = {"tm": JW.init_time_mix(k1, cj), "cm": JW.init_channel_mix(k2, cj)}
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    return cj, ct, pj, pt


def _rwkv_state(seed, cfg, B):
    r = np.random.default_rng(seed)
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return {"tm": {"last": r.standard_normal((B, d)).astype(np.float32),
                   "wkv": r.standard_normal((B, d // hs, hs, hs))
                   .astype(np.float32) * 0.3},
            "cm": {"last": r.standard_normal((B, d)).astype(np.float32)}}


def test_param_dtypes_follow_jax():
    """mix, decay and bonus params and ln_x stay fp32 in a bf16 model."""
    cj = jconfigs.get_config(ARCH).replace(d_model=128, d_ff=256)
    ct = tconfigs.get_config(ARCH).replace(d_model=128, d_ff=256)
    pj = JW.init_time_mix(jax.random.PRNGKey(0), cj)
    pt = TW.init_time_mix(torch.Generator().manual_seed(0), ct, "cpu")
    dt_j = jax.tree_util.tree_map(lambda a: str(a.dtype), pj)
    dt_t = bridge._map(lambda t: str(t.dtype).replace("torch.", ""), pt)
    assert dt_j == dt_t
    assert dt_t["decay_base"] == "float32" and dt_t["w_r"] == "bfloat16"


@pytest.mark.parametrize("S", [1, 9, 37])
def test_time_and_channel_mix_match_jax(mix_params, S):
    """Prefill of S tokens from a carried state, then two decode steps."""
    cj, ct, pj, pt = mix_params
    r = np.random.default_rng(S)
    x = r.standard_normal((2, S + 2, ct.d_model)).astype(np.float32)
    st = _rwkv_state(6, ct, 2)
    sj = jax.tree_util.tree_map(jnp.asarray, st)
    stt = bridge.params_from_jax(st, "cpu")
    wkv_buf = stt["tm"]["wkv"]
    steps = [(slice(0, S), True), (slice(S, S + 1), False),
             (slice(S + 1, S + 2), False)]
    for sl, chunked in steps:
        xj, xt = jnp.asarray(x[:, sl]), torch.from_numpy(x[:, sl])
        oj, sj["tm"] = JW.time_mix(pj["tm"], cj, xj, sj["tm"],
                                   use_chunked=chunked)
        ot, _ = TW.time_mix(pt["tm"], ct, xt, stt["tm"])
        assert _err(oj, ot) < TM_ATOL
        oj, sj["cm"] = JW.channel_mix(pj["cm"], cj, xj, sj["cm"])
        ot, _ = TW.channel_mix(pt["cm"], ct, xt, stt["cm"])
        assert _err(oj, ot) < CM_ATOL
    assert stt["tm"]["wkv"] is wkv_buf                 # updated in place
    for part, leaf in (("tm", "last"), ("tm", "wkv"), ("cm", "last")):
        assert _err(sj[part][leaf], stt[part][leaf]) < TM_ATOL
