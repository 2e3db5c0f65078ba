"""Parameter sharding rules (port of ``repro/parallel/sharding.py``, the
param-rule half).

Mesh axes of the production layout: ``data`` (FSDP over d_model),
``model`` (TP / EP over heads, d_ff, experts and vocab) and ``pod``
(pure DP). A spec is a `P`: a plain tuple with one entry per dimension,
each ``None``, an axis name or a tuple of axis names, as a JAX
``PartitionSpec`` lists them. No mesh object is involved: the testbed's
shard plane (`serving/shard.py`) reads the ``model`` entries to decide
which axis of each leaf its tensor-parallel slices split.

Ported here: `_PARAM_RULES`, `spec_for_param`, `_tree_paths`,
`param_specs` and `_drop_axes`. The mesh half of the JAX module
(`current_mesh`, `filter_spec`, `logical_constraint`, `param_shardings`,
`batch_spec`, `data_shardings`, `batch_shardings`,
`decode_cache_shardings`, `replicated`) is not: it waits for the port's
launch and layout substrate (``DeviceMesh`` / DTensor placements; ROADMAP
Queue 1, launch and layout).
"""

from __future__ import annotations

from typing import Any


class P(tuple):
    """Partition spec: one entry per dimension (None, an axis name, or a
    tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# Leaf-name -> spec template, by *trailing* path component. Templates are
# written for the full (pod, data, model) mesh.
_PARAM_RULES = {
    # embedding / head
    "table":   P("model", "data"),
    # attention
    "wq":      P("data", "model", None),
    "wk":      P("data", "model", None),
    "wv":      P("data", "model", None),
    "wo":      P("model", None, "data"),
    "bq":      P("model", None),
    "bk":      P("model", None),
    "bv":      P("model", None),
    # mlp
    "w_gate":  P("data", "model"),
    "w_up":    P("data", "model"),
    "w_down":  P("model", "data"),
    "w_in":    P("data", "model"),
    "w_out":   P("model", "data"),
    "b_in":    P("model"),
    "b_out":   P(None),
    # MoE (leading expert dim)
    "we_gate": P("model", "data", None),
    "we_up":   P("model", "data", None),
    "we_down": P("model", None, "data"),
    "router":  P("data", None),
    # RG-LRU recurrent block
    "w_x":     P("data", "model"),
    "w_gate_rec": P("data", "model"),
    "conv_w":  P(None, "model"),
    "conv_b":  P("model"),
    "gate_a":  P("model", None, None),   # (blocks, w/b, w/b)
    "gate_x":  P("model", None, None),
    "log_lambda": P("model"),
    "w_out_rec": P("model", "data"),
    # RWKV-6
    "w_r":     P("data", "model"),
    "w_k":     P("data", "model"),
    "w_v":     P("data", "model"),
    "w_g":     P("data", "model"),
    "w_o":     P("model", "data"),
    "decay_w1": P("data", None),
    "decay_w2": P(None, "model"),
    "bonus_u": P("model", None),
    "mix":     P(None),
    # norms
    "scale":   P(None),
    "bias":    P(None),
}


def spec_for_param(path: str, shape) -> P:
    """Partition spec for one parameter, by path suffix.

    Stacked (scanned) block params carry a leading layer/cycle dim which
    is never sharded; we right-align the rule spec against the shape.
    """
    leaf = path.split("/")[-1]
    rule = _PARAM_RULES.get(leaf)
    if rule is None:
        return P(*([None] * len(shape)))
    extra = len(shape) - len(rule)
    if extra < 0:
        return P(*([None] * len(shape)))
    return P(*([None] * extra + list(rule)))


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def param_specs(shapes_tree) -> Any:
    """Map a tree of tensors (or anything with a ``.shape``) to a tree of
    partition specs."""
    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            t = [walk(v, f"{prefix}/{i}" if prefix else str(i))
                 for i, v in enumerate(tree)]
            return type(tree)(t)
        return spec_for_param(prefix, tree.shape)
    return walk(shapes_tree)


def _drop_axes(spec: P, axes: set) -> P:
    """`spec` with the mesh axes in `axes` removed (an entry left empty
    becomes None, one left with a single axis becomes that name)."""
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a not in axes)
            out.append(kept if len(kept) > 1 else (kept[0] if kept
                                                   else None))
        else:
            out.append(None if e in axes else e)
    return P(*out)
