"""The port's tensor-parallel shard plane on the testbed
(``repro_torch.parallel.sharding``, ``repro_torch.serving.shard``, the
worker's slice store) against the JAX package on the CPU.

The same smoke params (drawn by the JAX model from a seed and bridged)
go through the JAX partitioning functions and the port's: the sharding
rules and each leaf's split axis must be equal, every rank's slice and
the re-gathered tree bit-equal, and a tree with a lost rank zero-filled
must give the JAX model's logits (within 2e-4) and greedy tokens
(tests/test_torch_tpdegrade.py). tests/test_torch_tptestbed.py runs the
port's `MiniTestbed(tp_degree=2, device="cpu")` through the ladder.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.serving import shard as JSHARD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.experiment import workload as TWL  # noqa: E402
from repro_torch.parallel import sharding as TSH  # noqa: E402
from repro_torch.serving import shard as TSHARD  # noqa: E402
from repro_torch.serving.server import WorkerServer  # noqa: E402

ARCHS = tconfigs.ARCHS


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _leaves(tree):
    """Leaves of a dict/list tree in walk order, as float32 numpy."""
    return [_f32(leaf) for _p, leaf in JSH._tree_paths(tree)]


def _spec_paths(tree, prefix=""):
    """(path, spec) pairs of a spec tree whose leaves are port `P`s."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        assert isinstance(tree, TSH.P), tree
        yield prefix, tree


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, JAX numpy tree, the same tree bridged to the port)."""
    cj = jconfigs.get_smoke(request.param)
    pj = _np_tree(JM.init_params(jax.random.PRNGKey(7), cj))
    return request.param, pj, bridge.params_from_jax(pj, "cpu")


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

def test_param_rules_are_jaxs():
    assert list(TSH._PARAM_RULES) == list(JSH._PARAM_RULES)
    for name, rule in TSH._PARAM_RULES.items():
        assert tuple(rule) == tuple(JSH._PARAM_RULES[name]), name
        assert isinstance(rule, tuple)


def test_param_specs_match_jax(smoke):
    arch, pj, pt = smoke
    assert [p for p, _ in TSH._tree_paths(pt)] == \
        [p for p, _ in JSH._tree_paths(pj)]
    jspecs = dict(JSH._tree_paths(JSH.param_specs(pj)))
    tspecs = dict(_spec_paths(TSH.param_specs(pt)))
    assert list(tspecs) == list(jspecs)
    for path, spec in tspecs.items():
        assert tuple(spec) == tuple(jspecs[path]), (arch, path)
    # stacked leaves are right-aligned against the rule
    assert TSH.spec_for_param("cycles/0/attn/wq", (3, 8, 4, 2)) == \
        (None, "data", "model", None)
    assert TSH.spec_for_param("x/unknown", (2, 3)) == (None, None)
    assert TSH.spec_for_param("x/wq", (5,)) == (None,)


def test_drop_axes_variants():
    """tests/test_serving_layout.py's four cases on the port's `P`."""
    P = TSH.P
    assert TSH._drop_axes(P("data", "model"), {"data"}) == P(None, "model")
    assert TSH._drop_axes(P(("pod", "data"), None), {"data", "pod"}) == \
        P(None, None)
    assert TSH._drop_axes(P(("pod", "model"), "data"), {"pod", "data"}) == \
        P("model", None)
    assert TSH._drop_axes(P("model", None, "data"), {"data"}) == \
        P("model", None, None)
    assert repr(P("model", None)) == "P('model', None)"


# ---------------------------------------------------------------------------
# partitioning: split axes, slices, gathers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_split_axes_slices_and_gather_match_jax(smoke, k):
    arch, pj, pt = smoke
    axes = TSHARD.split_axes(pt, k)
    assert axes == JSHARD.split_axes(pj, k), arch
    assert any(a is not None for _p, a in JSH._tree_paths(axes))
    whole = _leaves(pj)
    parts = []
    for rank in range(k):
        got = TSHARD.rank_slice(pt, axes, k, rank)
        want = JSHARD.rank_slice(pj, axes, k, rank)
        for a, b in zip(_leaves(bridge.params_to_numpy(got)), _leaves(want),
                        strict=True):
            assert a.shape == b.shape and np.array_equal(a, b), (arch, rank)
        parts.append(got)
    # a split leaf owns its bytes (the full draw can be freed)
    for (_p, leaf), (_q, ax) in zip(TSH._tree_paths(parts[0]),
                                    JSH._tree_paths(axes)):
        if ax is not None:
            assert leaf.is_contiguous() and leaf._base is None
    gathered = TSHARD.gather(parts, axes)
    for a, b in zip(_leaves(bridge.params_to_numpy(gathered)), whole,
                    strict=True):
        assert np.array_equal(a, b)


def test_rank_slice_has_array_split_sections():
    """Uneven splits: 10 heads at k = 3 are cut 4, 3, 3, as
    `np.array_split` cuts them, and a dimension below k stays whole."""
    leaf = np.arange(2 * 10 * 4, dtype=np.float32).reshape(2, 10, 4)
    tree = {"attn": {"wq": leaf, "bq": np.ones((2, 4), np.float32)}}
    tt = bridge.params_from_jax(tree, "cpu")
    axes = TSHARD.split_axes(tt, 3)
    assert axes == JSHARD.split_axes(tree, 3) == \
        {"attn": {"wq": 1, "bq": None}}
    for rank, n in enumerate((4, 3, 3)):
        got = TSHARD.rank_slice(tt, axes, 3, rank)["attn"]["wq"].numpy()
        assert got.shape == (2, n, 4)
        assert np.array_equal(got, np.array_split(leaf, 3, axis=1)[rank])


def test_zero_slice_and_meta():
    tree = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
            "b": [torch.ones(2, dtype=torch.float32)]}
    meta = TSHARD.slice_meta(tree, {"a": 1, "b": [None]})
    z = TSHARD.zero_slice(meta)
    assert z["a"].dtype == torch.bfloat16 and z["a"].shape == (3, 4)
    assert z["b"][0].dtype == torch.float32 and not z["b"][0].any()
    assert z["a"].device.type == "cpu"


def test_checkpoint_is_the_workers_draw():
    """`checkpoint_params` draws exactly what `WorkerServer.load` draws,
    so the gathered tree of every k is bit-equal to a monolith load."""
    for arch in ("qwen2.5-3b", "rwkv6-3b"):
        full = TWL.testbed_ladder(arch)[0]
        w = WorkerServer("w0", _NoDetector(), device="cpu")
        w.load(None, full)
        loaded = w.engines[full.name].params
        ckpt = TSHARD.checkpoint_params(full, "cpu")
        want = _leaves(bridge.params_to_numpy(loaded))
        assert all(np.array_equal(a, b) for a, b in zip(
            _leaves(bridge.params_to_numpy(ckpt)), want, strict=True))
        for k in (2, 3):
            axes = TSHARD.split_axes(ckpt, k)
            parts = [TSHARD.rank_slice(ckpt, axes, k, r) for r in range(k)]
            got = _leaves(bridge.params_to_numpy(TSHARD.gather(parts, axes)))
            assert all(np.array_equal(a, b)
                       for a, b in zip(got, want, strict=True))


class _NoDetector:
    def beat(self, _sid):
        pass
