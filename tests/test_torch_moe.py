"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on qwen3-moe-30b-a3b SMOKE params made by JAX and passed
through the params bridge.

The capacity-bucketed dispatch must drop the same (token, choice) slots
as JAX: with a capacity factor small enough that experts overflow, the
port's slot grid is held against the drops that JAX's own routing and
rule (a stable sort by expert, each expert's first C slots kept) give,
and the outputs must agree, which they could not if another slot were
dropped. The dense oracle and the load-balancing aux loss are held
against JAX too (atol 2e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
ATOL = 2e-5
B, S = 2, 24


def _setup(capacity_factor=None, dense_residual_d_ff=0, seed=0):
    over = {}
    if capacity_factor is not None:
        over["capacity_factor"] = capacity_factor
    if dense_residual_d_ff:
        over["dense_residual_d_ff"] = dense_residual_d_ff
    cj = jconfigs.get_smoke(ARCH).replace(**over)
    ct = tconfigs.get_smoke(ARCH).replace(**over)
    pj = JMOE.init_moe(jax.random.PRNGKey(seed), cj)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cj.d_model)).astype(np.float32)
    return cj, ct, pj, pt, x


def _jax_drops(pj, cj, x):
    """The (token, choice) slots JAX's dispatch drops, from JAX's own
    routing and its rule: stable sort by expert, slot = rank within the
    expert, dropped when slot >= C."""
    T = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ pj["router"],
                           axis=-1)
    _, idx = jax.lax.top_k(probs, cj.top_k)
    flat_e = np.asarray(idx).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    rank = np.empty_like(order)
    for e in np.unique(flat_e):
        members = order[flat_e[order] == e]
        rank[members] = np.arange(len(members))
    C = JMOE._capacity(T, cj)
    return set(np.nonzero(rank >= C)[0].tolist()), C


@pytest.mark.parametrize("capacity_factor", [None, 0.5, 0.25])
def test_moe_ffn_matches_jax_with_the_same_drops(capacity_factor):
    cj, ct, pj, pt, x = _setup(capacity_factor)
    yj, aux_j = JMOE.moe_ffn(pj, cj, jnp.asarray(x))
    yt, aux_t = TMOE.moe_ffn(pt, ct, torch.from_numpy(x))
    assert float(np.max(np.abs(np.asarray(yj) - yt.numpy()))) < ATOL
    assert abs(float(aux_j) - float(aux_t)) < ATOL

    want, C = _jax_drops(pj, cj, x)
    assert C == TMOE._capacity(B * S, ct)
    _, _, idx = TMOE._route(pt, ct, torch.from_numpy(x).reshape(B * S, -1))
    slot_tok, slot_of = TMOE.dispatch(idx, ct.num_experts, C)
    got = set(torch.nonzero(slot_of == ct.num_experts * C)[:, 0].tolist())
    assert got == want
    if capacity_factor is None:
        assert not want                      # SMOKE's 4.0 drops nothing
    else:
        assert want                          # small enough to overflow
        # the drops change the output: the dense oracle (no drops) differs
        dense = TMOE.moe_ffn_dense_ref(pt, ct, torch.from_numpy(x))
        assert float((dense - yt).abs().max()) > 1e-3
    # every kept slot holds its token, in the grid JAX builds
    kept = slot_of[slot_of < ct.num_experts * C]
    assert len(set(kept.tolist())) == len(kept)
    assert int((slot_tok < B * S).sum()) == len(kept)


def test_moe_ffn_dense_ref_matches_jax():
    cj, ct, pj, pt, x = _setup()
    yj = JMOE.moe_ffn_dense_ref(pj, cj, jnp.asarray(x))
    yt = TMOE.moe_ffn_dense_ref(pt, ct, torch.from_numpy(x))
    assert float(np.max(np.abs(np.asarray(yj) - yt.numpy()))) < ATOL
    # without drops the dispatch path equals the oracle
    y, _ = TMOE.moe_ffn(pt, ct, torch.from_numpy(x))
    assert float((y - yt).abs().max()) < ATOL


def test_moe_with_dense_residual_matches_jax():
    """The arctic-style dense residual branch (``moe_dense``)."""
    cj, ct, pj, pt, x = _setup(dense_residual_d_ff=48, seed=1)
    assert "dense" in pt
    yj, aux_j = JMOE.moe_ffn(pj, cj, jnp.asarray(x))
    yt, aux_t = TMOE.moe_ffn(pt, ct, torch.from_numpy(x))
    assert float(np.max(np.abs(np.asarray(yj) - yt.numpy()))) < ATOL
    assert abs(float(aux_j) - float(aux_t)) < ATOL


def test_moe_bf16_matches_jax():
    """bf16 activations and expert weights (the router stays fp32), the
    silu-in-fp32-then-cast order of the JAX FFN."""
    cj, ct, pj, pt, x = _setup(capacity_factor=0.5, seed=2)
    pj = {k: (v if k == "router" else v.astype(jnp.bfloat16))
          for k, v in pj.items()}
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    assert pt["router"].dtype == torch.float32
    assert pt["we_gate"].dtype == torch.bfloat16
    xb = jnp.asarray(x, jnp.bfloat16)
    yj, aux_j = JMOE.moe_ffn(pj, cj, xb)
    yt, aux_t = TMOE.moe_ffn(pt, ct, torch.from_numpy(
        np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    err = float(np.max(np.abs(np.asarray(yj.astype(jnp.float32))
                              - yt.float().numpy())))
    assert err < 2e-2
    assert abs(float(aux_j) - float(aux_t)) < ATOL


def test_capacity_rule_matches_jax():
    cj, ct = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    for tokens in (1, 4, 7, 64, 256, 1000):
        assert TMOE._capacity(tokens, ct) == JMOE._capacity(tokens, cj)
