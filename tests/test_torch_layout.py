"""The port's launch and layout layer (``repro_torch.launch.mesh``, the
mesh half of ``repro_torch.parallel.sharding``, ``repro_torch.configs.
shapes``, ``repro_torch.launch.hlo_analysis``, ``param_shapes``) against
the JAX package on the CPU.

JAX lays out on ``jax.sharding.AbstractMesh`` (no devices), whose
``NamedSharding.shard_shape`` is the reference; the port on its own
``AbstractMesh``. Every comparison is exact: specs entry for entry,
shard shapes, shapes and dtypes, and the roofline's floats.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as JS  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.launch import hlo_analysis as TH  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as TSH  # noqa: E402
from repro_torch.training.optimizer import AdamW as TAdamW  # noqa: E402
from repro_torch.training.optimizer import state_shardings  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.ARCHS
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return JAbstractMesh(shape, axes), TMESH.AbstractMesh(shape, axes)


def _dtype(d):
    """A JAX or torch dtype's name ("bfloat16", "int32", ...)."""
    return str(d).replace("torch.", "")


def _paired(jtree, ttree):
    """(path, JAX leaf, port leaf) over two trees of one layout (dicts,
    lists, NamedTuples), by path; the two path sets equal."""
    jl = dict(JSH._tree_paths(_plain(jtree)))
    tl = dict(TSH._tree_paths(_plain(ttree)))
    assert sorted(jl) == sorted(tl)
    return [(p, jl[p], tl[p]) for p in sorted(jl)]


def _plain(tree):
    """NamedTuples as dicts of their fields, so ``_tree_paths`` names
    them."""
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _spec_paths(tree, prefix=""):
    """(path, spec) of a tree of dicts and lists whose leaves are specs
    (a port `P` is a tuple: it is a leaf here)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _same_shardings(jsh, tsh, shapes):
    """Spec for spec and shard shape for shard shape, over paired trees
    of JAX NamedShardings, port NamedShardings and leaves (JAX's)."""
    n = 0
    for (path, js, ts), (_, _, leaf) in zip(_paired(jsh, tsh),
                                            _paired(shapes, shapes)):
        assert isinstance(js, JNamedSharding) and \
            isinstance(ts, TSH.NamedSharding), path
        assert tuple(js.spec) == tuple(ts.spec), (path, js.spec, ts.spec)
        assert tuple(js.shard_shape(tuple(leaf.shape))) == \
            ts.shard_shape(tuple(leaf.shape)), path
        n += 1
    return n


# ---------------------------------------------------------------------------
# Shapes: param_shapes, input_specs, the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_jax(arch):
    """Every leaf of the full-size param tree: path, shape and dtype equal
    to the JAX ``param_shapes``', and nothing allocated (meta)."""
    pairs = _paired(JM.param_shapes(jconfigs.get_config(arch)),
                    TM.param_shapes(tconfigs.get_config(arch)))
    assert pairs
    for path, j, t in pairs:
        assert t.device.type == "meta", path
        assert tuple(j.shape) == tuple(t.shape), path
        assert _dtype(j.dtype) == _dtype(t.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_caches_match_jax(arch):
    """``input_specs`` of all four cells and the meta cache of each
    serving cell: shapes and dtypes equal to JAX's."""
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name in TS.SHAPES:
        js = JS.input_specs(jc, JS.SHAPES[name])
        ts = TS.input_specs(tc, TS.SHAPES[name])
        assert list(js) == list(ts), name
        for k in js:
            assert ts[k].device.type == "meta"
            assert tuple(js[k].shape) == tuple(ts[k].shape), (name, k)
            assert _dtype(js[k].dtype) == _dtype(ts[k].dtype), (name, k)
        cell = TS.SHAPES[name]
        if cell.kind == "train":
            continue
        jcache = jax.eval_shape(lambda: JM.init_cache(
            jc, cell.global_batch, cell.seq_len))
        tcache = TM.init_cache(tc, cell.global_batch, cell.seq_len,
                               device="meta")
        for path, j, t in _paired(jcache, tcache):
            assert tuple(j.shape) == tuple(t.shape), (name, path)
            assert _dtype(j.dtype) == _dtype(t.dtype), (name, path)


def test_shape_cells_cover_40():
    """tests/test_archs.py::test_shape_cells_cover_40 on the port, and the
    cells themselves equal to JAX's."""
    assert {k: (c.name, c.kind, c.seq_len, c.global_batch)
            for k, c in TS.SHAPES.items()} == \
        {k: (c.name, c.kind, c.seq_len, c.global_batch)
         for k, c in JS.SHAPES.items()}
    assert TS.LONG_OK == JS.LONG_OK
    cells = [(a, s) for a in ARCHS for s in TS.SHAPES]
    assert len(cells) == 40
    runnable = [(a, s) for a in ARCHS for s in TS.applicable_cells(a)]
    assert len(runnable) == 33
    assert runnable == [(a, s) for a in jconfigs.ARCHS
                        for s in JS.applicable_cells(a)]


def test_resolve_device_meta_only_when_named():
    from repro_torch.device import resolve_device
    assert resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()


# ---------------------------------------------------------------------------
# Shardings: params (serving and not), batches, data, caches, replicated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_jax(arch, mesh_name):
    """``param_specs`` and ``param_shardings`` (serving and not) of every
    leaf at full size, and AdamW's state shardings, equal to JAX's."""
    jm, tm = _meshes(mesh_name)
    jshapes = JM.param_shapes(jconfigs.get_config(arch))
    tshapes = TM.param_shapes(tconfigs.get_config(arch))
    jspecs = dict(_spec_paths(JSH.param_specs(jshapes)))
    tspecs = dict(_spec_paths(TSH.param_specs(tshapes)))
    assert jspecs.keys() == tspecs.keys()
    for path, js in jspecs.items():
        assert isinstance(tspecs[path], TSH.P)
        assert tuple(js) == tuple(tspecs[path]), path
    for serving in (False, True):
        _same_shardings(JSH.param_shardings(jshapes, jm, serving=serving),
                        TSH.param_shardings(tshapes, tm, serving=serving),
                        jshapes)
    jopt = JAdamW().state_shapes(jshapes)
    topt = TAdamW().state_shapes(tshapes)
    tsh = state_shardings(topt, tm)
    for f in ("m", "v", "master"):
        _same_shardings(JSH.param_shardings(getattr(jopt, f), jm),
                        getattr(tsh, f), getattr(jopt, f))
    assert tsh.step.spec == TSH.P() and tsh.step.shard_shape(()) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shardings_match_jax(arch, mesh_name):
    """Every cell's inputs (``batch_shardings``, ``data_shardings`` at
    ``BATCH`` and at ``batch_spec``, ``replicated``) and every serving
    cell's cache (``decode_cache_shardings``; long_500k at B=1 takes the
    sequence parallel layout) equal to JAX's."""
    jm, tm = _meshes(mesh_name)
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name in TS.SHAPES:
        cell = TS.SHAPES[name]
        jb = JS.input_specs(jc, JS.SHAPES[name])
        tb = TS.input_specs(tc, cell)
        _same_shardings(JSH.batch_shardings(jb, jm),
                        TSH.batch_shardings(tb, tm), jb)
        _same_shardings(JSH.data_shardings(jb, jm, JSH.BATCH),
                        TSH.data_shardings(tb, tm, TSH.BATCH), jb)
        _same_shardings(JSH.replicated(jb, jm), TSH.replicated(tb, tm), jb)
        for k, v in jb.items():
            if len(v.shape) < 2:
                continue
            spec_j = JSH.batch_spec(len(v.shape), seq_axis=1,
                                    shard_seq=True)
            spec_t = TSH.batch_spec(len(v.shape), seq_axis=1,
                                    shard_seq=True)
            assert tuple(spec_j) == tuple(spec_t)
            _same_shardings(JSH.data_shardings({k: v}, jm, spec_j),
                            TSH.data_shardings({k: tb[k]}, tm, spec_t),
                            {k: v})
        if cell.kind == "train":
            continue
        jcache = jax.eval_shape(lambda: JM.init_cache(
            jc, cell.global_batch, cell.seq_len))
        tcache = TM.init_cache(tc, cell.global_batch, cell.seq_len,
                               device="meta")
        assert _same_shardings(JSH.decode_cache_shardings(jcache, jm),
                               TSH.decode_cache_shardings(tcache, tm),
                               jcache) > 0


def test_long_context_cache_is_sequence_parallel():
    """long_500k at B=1 on 16x16: the KV sequence dim over the whole
    mesh, each device one 256th of it."""
    cfg = tconfigs.get_config("gemma3-27b")
    cell = TS.SHAPES["long_500k"]
    cache = TM.init_cache(cfg, cell.global_batch, cell.seq_len,
                          device="meta")
    tm = TMESH.make_production_mesh()
    sh = TSH.decode_cache_shardings(cache, tm)
    k, ksh = cache["cycles"][-1]["k"], sh["cycles"][-1]["k"]
    assert ksh.spec == TSH.P(None, None, ("data", "model"), None, None)
    assert ksh.shard_shape(k.shape)[2] == k.shape[2] // 256


def test_filter_spec_matches_jax_on_uneven_dims():
    """Prefixes of an axis tuple dropped until the dim divides, as JAX."""
    for mesh_name in MESHES:
        jm, tm = _meshes(mesh_name)
        for dims in [(1,), (2,), (6,), (32,), (48,), (1024,), (3, 64)]:
            for spec in [(("pod", "data", "model"),), (("pod", "data"),),
                         ("model",), ("data", "model")]:
                if len(spec) != len(dims):
                    continue
                assert tuple(JSH.filter_spec(JP(*spec), jm, dims)) == \
                    tuple(TSH.filter_spec(TSH.P(*spec), tm, dims)), \
                    (mesh_name, dims, spec)


def test_named_sharding_refuses_tuples_out_of_mesh_order():
    """Every rule lists a tuple in mesh order, the one order DTensor
    placements express; a tuple out of it is refused."""
    tm = TMESH.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        TSH.NamedSharding(tm, TSH.P(("data", "pod"), None))
    with pytest.raises(ValueError):
        TSH.NamedSharding(tm, TSH.P(("model", "data"),))
    for rule in TSH._PARAM_RULES.values():
        TSH.NamedSharding(tm, rule)
    for spec in (TSH.BATCH, TSH.P(None, ("pod", "data", "model"))):
        TSH.NamedSharding(tm, spec)


def test_production_meshes():
    single = TMESH.make_production_mesh()
    multi = TMESH.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.axis_sizes, single.size) == \
        (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, multi.axis_sizes, multi.size) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
    assert TMESH.mesh_name(multi) == "2x16x16"
    with pytest.raises(RuntimeError):
        TMESH.make_mesh((1, 1), ("data", "model"), device="cpu")


# ---------------------------------------------------------------------------
# current_mesh and logical_constraint
# ---------------------------------------------------------------------------

def test_current_mesh_contract():
    """None outside every scope; the innermost ``use_mesh`` inside, its
    axis names the mesh's; None again after (tests/test_sharding.py::
    test_current_mesh_abstract_path's contract)."""
    assert TSH.current_mesh() is None
    outer = TMESH.AbstractMesh((1, 1), ("data", "model"))
    inner = TMESH.make_production_mesh()
    with TSH.use_mesh(outer):
        got = TSH.current_mesh()
        assert got is outer and got.axis_names == ("data", "model")
        with TSH.use_mesh(inner):
            assert TSH.current_mesh() is inner
        assert TSH.current_mesh() is outer
    assert TSH.current_mesh() is None


def test_logical_constraint_without_a_device_mesh():
    """No mesh, or an abstract one: the tensor itself comes back."""
    x = torch.arange(12.0).reshape(3, 4)
    assert TSH.logical_constraint(x, TSH.P("data", "model")) is x
    with TSH.use_mesh(TMESH.make_production_mesh()):
        assert TSH.logical_constraint(x, TSH.P("data", "model")) is x


_FAKE_PG = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as MDL
from repro_torch.parallel import sharding as SH
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.tree import tree_leaves
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
out = {"mesh_inside": None}
with mesh:
    out["mesh_inside"] = SH.current_mesh() is mesh
    with SH.use_mesh(SH.current_mesh()):
        out["use_mesh"] = SH.current_mesh() is mesh
out["mesh_after"] = SH.current_mesh() is None
x = distribute_tensor(torch.zeros(8, 16), mesh, (Replicate(), Replicate()))
plain = torch.zeros(8, 16)
with SH.use_mesh(mesh):
    y = SH.logical_constraint(x, SH.P("data", "model"))
    out["plain_same"] = SH.logical_constraint(plain, SH.P("data")) is plain
out["constraint"] = [repr(p) for p in y.placements] + \
    [list(y.to_local().shape)]
for arch in configs.ARCHS:
    cfg = configs.get_smoke(arch)
    shapes = MDL.param_shapes(cfg)
    shs = SH.param_shardings(shapes, mesh)
    locs = []
    for leaf, sh in zip(tree_leaves(shapes), tree_leaves(shs)):
        t = CKPT._to_dtensor(torch.zeros(leaf.shape, dtype=leaf.dtype), sh)
        assert isinstance(t, DTensor) and tuple(t.shape) == tuple(leaf.shape)
        locs.append(list(t.to_local().shape))
    out[arch] = locs
print("RESULT " + json.dumps(out))
"""


def _run(code, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_dtensor_placements_on_a_fake_2x4_mesh():
    """On a (2, 4) ``DeviceMesh`` of a fake process group: ``current_mesh``
    inside and outside ``with mesh:``, ``logical_constraint`` of a
    replicated DTensor to ("data", "model") placements, and every SMOKE
    arch's param leaf as a DTensor whose local shape is JAX's
    ``shard_shape`` on a (2, 4) mesh."""
    res = _run(_FAKE_PG)
    assert res["mesh_inside"] and res["use_mesh"] and res["mesh_after"]
    assert res["plain_same"]
    assert res["constraint"] == ["Shard(dim=0)", "Shard(dim=1)", [4, 4]]
    jm = JAbstractMesh((2, 4), ("data", "model"))
    for arch in ARCHS:
        shapes = JM.param_shapes(jconfigs.get_smoke(arch))
        shs = JSH.param_shardings(shapes, jm)
        want = [list(s.shard_shape(tuple(leaf.shape))) for leaf, s in zip(
            jax.tree_util.tree_leaves(shapes),
            jax.tree_util.tree_leaves(
                shs, is_leaf=lambda x: isinstance(x, JNamedSharding)))]
        assert res[arch] == want, arch


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch):
    for name in TS.SHAPES:
        assert TH.model_flops_for(tconfigs.get_config(arch),
                                  TS.SHAPES[name]) == \
            JH.model_flops_for(jconfigs.get_config(arch), JS.SHAPES[name])


def test_roofline_terms_match_jax_with_h100_constants(monkeypatch):
    """The reference's formulas with the H100's constants in place of the
    TPU's; the constants are the card's."""
    assert (TH.PEAK_FLOPS, TH.HBM_BW, TH.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    monkeypatch.setattr(JH, "PEAK_FLOPS", TH.PEAK_FLOPS)
    monkeypatch.setattr(JH, "HBM_BW", TH.HBM_BW)
    monkeypatch.setattr(JH, "ICI_BW", TH.LINK_BW)
    rng = np.random.default_rng(0)
    for chips in (1, 8, 256, 512):
        for _ in range(8):
            kw = dict(arch="a", shape="s", mesh_name="m", chips=chips,
                      hlo_flops=float(rng.uniform(0, 1e18)),
                      hlo_bytes=float(rng.uniform(0, 1e15)),
                      coll_bytes=float(rng.uniform(0, 1e14)),
                      model_flops=float(rng.uniform(0, 1e18)),
                      temp_bytes=float(rng.uniform(0, 1e10)),
                      arg_bytes=float(rng.uniform(0, 1e10)))
            assert TH.roofline_terms(**kw).to_dict() == \
                JH.roofline_terms(**kw).to_dict()
    zero = dict(kw, hlo_flops=0.0)
    assert TH.roofline_terms(**zero).useful_flop_frac == 0.0


def test_collective_bytes_rule():
    """``collective_bytes_for``'s rule on the production mesh, and all
    zero on (1, 1): a train step gathers every FSDP-split leaf twice and
    reduce-scatters its gradient once; a serving-layout decode step
    gathers nothing; the all-reduces follow the activations."""
    cfg = tconfigs.get_config("qwen2.5-3b")
    shapes = TM.param_shapes(cfg)
    one = TMESH.AbstractMesh((1, 1), ("data", "model"))
    for name, cell in TS.SHAPES.items():
        coll = TH.collective_bytes_for(
            cfg, cell, TSH.param_shardings(shapes, one), one)
        assert all(v == 0 for v in coll.values()), name
    mesh = TMESH.make_production_mesh()
    sh = TSH.param_shardings(shapes, mesh)
    train = TH.collective_bytes_for(cfg, TS.SHAPES["train_4k"], sh, mesh)
    prefill = TH.collective_bytes_for(cfg, TS.SHAPES["prefill_32k"], sh,
                                      mesh)
    assert train["all-gather"] == 2 * prefill["all-gather"] > 0
    assert train["reduce-scatter"] > 0 == prefill["reduce-scatter"]
    assert train["all-to-all"] == train["collective-permute"] == 0
    # reduce-scatter out = the FSDP-split leaves' shards
    total_shard = 0
    for _, t, s in _paired(shapes, sh):
        axes = {a for e in s.spec
                for a in (e if isinstance(e, tuple) else (e,))}
        if axes & {"data", "pod"}:
            total_shard += math.prod(s.shard_shape(t.shape)) * \
                t.element_size()
    # all-reduce: 2 a block (forward) of (B/16, S, d) bf16, x2 in training
    act = (256 // 16) * 4096 * cfg.d_model * 2
    assert train["all-reduce"] == 256 * 4 * cfg.num_layers * act
    serve = TSH.param_shardings(shapes, mesh, serving=True)
    dec = TH.collective_bytes_for(cfg, TS.SHAPES["decode_32k"], serve, mesh)
    assert dec["all-gather"] == dec["reduce-scatter"] == 0
    assert dec["all-reduce"] == 256 * 2 * cfg.num_layers * \
        (128 // 16) * cfg.d_model * 2
    assert dec["total"] == sum(dec[k] for k in TH.COLLECTIVE_OPS)
