"""Degraded-TP trees of the port's shard plane against the JAX model on
the CPU: the same smoke params, drawn by the JAX model from a seed and
bridged, are split into k rank slices by each package, one rank is
zero-filled (as the testbed's degraded rebuild does for a lost member)
and the slices are gathered. The two trees must be bit-equal, and the
port's prefill and decode steps on its tree must give the JAX model's
logits on the JAX tree within 2e-4, with equal greedy tokens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.serving import shard as JSHARD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import shard as TSHARD  # noqa: E402

# the archs of tests/test_torch_model.py, which the testbed serves
ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "rwkv6-3b", "qwen3-32b",
         "qwen3-moe-30b-a3b"]
ATOL = 2e-4
B, P, N_DECODE = 2, 10, 3
J_PREFILL = jax.jit(JM.prefill, static_argnums=1)
J_DECODE = jax.jit(JM.decode_step, static_argnums=1)


def _leaves(tree):
    """Leaves of a dict/list tree in walk order, as float32 numpy."""
    return [np.asarray(leaf).astype(np.float32)
            for _p, leaf in JSH._tree_paths(tree)]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cj, ct = jconfigs.get_smoke(request.param), \
        tconfigs.get_smoke(request.param)
    pj = jax.tree_util.tree_map(np.asarray,
                                JM.init_params(jax.random.PRNGKey(1), cj))
    return cj, ct, pj, bridge.params_from_jax(pj, "cpu")


def _degraded(jmod, tree, k, lost):
    axes = jmod.split_axes(tree, k)
    parts = [jmod.rank_slice(tree, axes, k, r) for r in range(k)]
    parts[lost] = jmod.zero_slice(jmod.slice_meta(parts[lost], axes))
    return jmod.gather(parts, axes)


@pytest.mark.parametrize("k,lost", [(2, 0), (2, 1), (3, 0), (3, 2)])
def test_degraded_tree_matches_jax_model(smoke, k, lost):
    """Rank 0 or rank k-1 zero-filled. A lost rank 0 also zeroes the
    replicated leaves (every norm's scale), which `gather` takes from the
    first rank in both packages (ROADMAP R9)."""
    cj, ct, pj, pt = smoke
    dj = _degraded(JSHARD, pj, k, lost)
    dt = _degraded(TSHARD, pt, k, lost)
    for a, b in zip(_leaves(bridge.params_to_numpy(dt)), _leaves(dj),
                    strict=True):
        assert np.array_equal(a, b)
    toks = np.random.default_rng(k * 10 + lost).integers(
        0, cj.vocab_size, (B, P)).astype(np.int32)
    cache_j = JM.init_cache(cj, B, P + N_DECODE + 1)
    cache_t = TM.init_cache(ct, B, P + N_DECODE + 1, device="cpu")
    with torch.inference_mode():
        lj, cache_j = J_PREFILL(dj, cj, jnp.asarray(toks), cache_j)
        lt, cache_t = TM.prefill(dt, ct, torch.from_numpy(toks), cache_t)
        for _ in range(N_DECODE + 1):
            assert np.isfinite(np.asarray(lj, np.float32)).all()
            err = np.max(np.abs(np.asarray(lj, np.float32)
                                - lt.float().numpy()))
            assert err < ATOL, (cj.name, k, lost, err)
            # R9: a zero final-norm scale leaves nothing of the logits
            assert (lost == 0) == (not lt.any())
            tj = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
            tt = torch.argmax(lt, dim=-1).to(torch.int32)
            assert tt.tolist() == tj.tolist()
            lj, cache_j = J_DECODE(dj, cj, jnp.asarray(tj), cache_j)
            lt, cache_t = TM.decode_step(dt, ct, tt, cache_t)
