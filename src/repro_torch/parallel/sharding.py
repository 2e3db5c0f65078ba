"""Sharding rules: DP / FSDP / TP / EP / SP over the production mesh (port
of ``repro/parallel/sharding.py``).

Mesh axes (``launch/mesh.py``):
    single-pod : (data=16, model=16)
    multi-pod  : (pod=2, data=16, model=16)

Conventions
-----------
* batch           -> ("pod", "data")          (pure DP over pods)
* d_model of params -> "data"                  (FSDP / ZeRO-3 style)
* heads / d_ff / experts / vocab -> "model"    (TP / EP)
* decode KV sequence -> "model"                (flash-decoding split-KV)
* long-context KV sequence -> ("data","model") when batch == 1 (SP)

A spec is a `P`: a plain tuple with one entry per dimension, each
``None``, an axis name or a tuple of axis names, as a JAX
``PartitionSpec`` lists them. The param rules need no mesh: the
testbed's shard plane (`serving/shard.py`) reads the ``model`` entries to
decide which axis of each leaf its tensor-parallel slices split.

The mesh half takes either kind of mesh (``launch/mesh.py``): an
``AbstractMesh`` (names and sizes, the production meshes) or a
``DeviceMesh``. A `NamedSharding` is (mesh, spec): its ``shard_shape``
is a device's block of a global shape, and on a ``DeviceMesh`` its
``placements`` are the DTensor placements of the same layout. All helpers
degrade gracefully: axes missing from the mesh are dropped from specs,
as are axes that do not divide the dimension, so every split is even.

The port's model runs its kernels on local tensors and calls no
`logical_constraint` (ROADMAP P15); the dry run and the elastic restore
are the mesh half's callers.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Optional

from repro_torch.launch.mesh import AbstractMesh, axis_sizes


class P(tuple):
    """Partition spec: one entry per dimension (None, an axis name, or a
    tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_ABSTRACT_SCOPES: list = []     # use_mesh(AbstractMesh) scopes, innermost last


def _device_mesh_stack():
    """The meshes of the enclosing ``with device_mesh:`` scopes, innermost
    last (``DeviceMesh``'s own context, which DTensor reads too)."""
    import torch.distributed as dist
    if not dist.is_available():
        return []
    from torch.distributed.device_mesh import _mesh_resources
    if not hasattr(_mesh_resources, "mesh_stack"):
        raise RuntimeError("this torch keeps no DeviceMesh context stack "
                           "(_mesh_resources.mesh_stack)")
    return _mesh_resources.mesh_stack


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (`current_mesh`) inside the block:
    an ``AbstractMesh`` or a ``DeviceMesh`` (whose own context is entered,
    so DTensor sees it too)."""
    if not isinstance(mesh, AbstractMesh):
        with mesh:
            yield mesh
        return
    _ABSTRACT_SCOPES.append(mesh)
    try:
        yield mesh
    finally:
        _ABSTRACT_SCOPES.pop()


def current_mesh():
    """The mesh of the innermost enclosing ``with device_mesh:`` scope,
    else of the innermost ``use_mesh(abstract_mesh)``, else None: a real
    mesh hides an abstract one (a process lays out on one kind)."""
    devices = _device_mesh_stack()
    if devices:
        return devices[-1]
    return _ABSTRACT_SCOPES[-1] if _ABSTRACT_SCOPES else None


def _mesh_sizes(mesh):
    return axis_sizes(mesh)


def filter_spec(spec: P, mesh, shape=None) -> P:
    """Drop mesh axes that are absent or do not divide the dimension."""
    sizes = _mesh_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes)
        if shape is not None and axes:
            total = math.prod(sizes[a] for a in axes)
            if shape[i] % total != 0:
                # try progressively shorter prefixes of the axis tuple
                while axes:
                    total = math.prod(sizes[a] for a in axes)
                    if shape[i] % total == 0:
                        break
                    axes = axes[:-1]
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


class NamedSharding:
    """A layout: ``spec`` over ``mesh`` (either kind). Each tensor dim
    split over a tuple of mesh axes is split major axis first, as JAX
    splits ``("pod", "data")``; a tuple must list its axes in mesh order,
    the one order DTensor placements can express."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        order = list(_mesh_sizes(mesh))
        for e in self.spec:
            axes = e if isinstance(e, tuple) else (e,)
            idx = [order.index(a) for a in axes if a is not None]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: {e} is not in the mesh's "
                                 f"axis order {tuple(order)}")

    def shard_shape(self, global_shape):
        """One device's block of ``global_shape``."""
        sizes = _mesh_sizes(self.mesh)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than "
                             f"{tuple(global_shape)} has dims")
        out = list(global_shape)
        for i, e in enumerate(self.spec):
            if e is None:
                continue
            n = math.prod(sizes[a] for a in (e if isinstance(e, tuple)
                                             else (e,)))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does "
                                 f"not split {n} ways ({self.spec})")
            out[i] //= n
        return tuple(out)

    @property
    def placements(self):
        """DTensor placements, one a mesh dim: ``Shard(d)`` where the spec
        splits tensor dim d over that axis, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        if isinstance(self.mesh, AbstractMesh):
            raise TypeError("an abstract mesh has no placements")
        dim_of = {}
        for d, e in enumerate(self.spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    dim_of[a] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in _mesh_sizes(self.mesh))

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh == self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash(self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def logical_constraint(x, spec: P):
    """``with_sharding_constraint`` that is a no-op without a mesh: a
    DTensor under an ambient ``DeviceMesh`` is redistributed to the
    filtered spec's placements; a plain tensor, or any tensor outside a
    mesh or under an abstract one (no devices), comes back unchanged."""
    mesh = current_mesh()
    if mesh is None or isinstance(mesh, AbstractMesh):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    fs = filter_spec(spec, mesh, x.shape)
    return x.redistribute(mesh, NamedSharding(mesh, fs).placements)


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

# Leaf-name -> spec template, by *trailing* path component. Templates are
# written for the full (pod, data, model) mesh; filter_spec() adapts them.
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


def param_shardings(shapes_tree, mesh, *, serving: bool = False):
    """NamedShardings for a param tree, with divisibility-aware filtering.

    serving=True = weight-stationary layout: the FSDP ("data"/"pod")
    axes are dropped so weights are only TP-sharded — no per-step weight
    all-gathers at decode (used when params/TP-shard fit the cell HBM).
    """
    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            t = [walk(v, f"{prefix}/{i}" if prefix else str(i))
                 for i, v in enumerate(tree)]
            return type(tree)(t)
        spec = spec_for_param(prefix, tree.shape)
        if serving:
            spec = _drop_axes(spec, {"data", "pod"})
        return NamedSharding(mesh, filter_spec(spec, mesh, tree.shape))
    return walk(shapes_tree)


# Common activation/data specs --------------------------------------------

BATCH = P(("pod", "data"))


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def batch_spec(ndim: int, *, seq_axis: Optional[int] = None,
               shard_seq: bool = False) -> P:
    entries: list = [("pod", "data")] + [None] * (ndim - 1)
    if shard_seq and seq_axis is not None:
        entries[seq_axis] = "model"
    return P(*entries)


def data_shardings(tree, mesh, spec: P):
    return _map_leaves(lambda leaf: NamedSharding(
        mesh, filter_spec(spec, mesh, leaf.shape)), tree)


def batch_shardings(batch_shapes, mesh):
    """Shardings for input batches: leading batch dim over (pod, data)."""
    def walk(leaf):
        spec = P(*([("pod", "data")] + [None] * (len(leaf.shape) - 1)))
        return NamedSharding(mesh, filter_spec(spec, mesh, leaf.shape))
    return _map_leaves(walk, batch_shapes)


def decode_cache_shardings(cache_shapes, mesh):
    """Shardings for decode caches (KV buffers + recurrent states).

    KV (.../B, S, KVH, hd): batch over (pod, data), sequence over "model"
    (flash-decoding split-KV).  When the batch does not divide the data
    axes (long_500k, B=1) the sequence dim takes (pod, data, model) —
    sequence parallelism over the full mesh.
    """
    sizes = _mesh_sizes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)([walk(v, name) for v in tree])
        shape = tree.shape
        nd = len(shape)
        if name in ("k", "v") and nd >= 4:
            B = shape[-4]
            lead = [None] * (nd - 4)
            if B % dp == 0 and dp > 1:
                spec = P(*lead, ("pod", "data"), "model", None, None)
            else:
                spec = P(*lead, None, ("pod", "data", "model"), None, None)
        elif name == "wkv" and nd >= 4:
            lead = [None] * (nd - 4)
            spec = P(*lead, ("pod", "data"), "model", None, None)
        elif name in ("h", "last") and nd >= 2:
            lead = [None] * (nd - 2)
            spec = P(*lead, ("pod", "data"), "model")
        elif name == "conv" and nd >= 3:
            lead = [None] * (nd - 3)
            spec = P(*lead, ("pod", "data"), None, "model")
        elif name == "pos":
            spec = P(*([None] * (nd - 1)), ("pod", "data"))
        else:
            spec = P(*([None] * nd))
        return NamedSharding(mesh, filter_spec(spec, mesh, shape))
    return walk(cache_shapes)


def replicated(tree, mesh):
    return _map_leaves(lambda leaf: NamedSharding(
        mesh, P(*([None] * len(leaf.shape)))), tree)
