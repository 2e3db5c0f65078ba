"""The port's dry run (``repro_torch.launch.dryrun``: meta-device
accounting) against the JAX package's layout on the CPU.

A cell's per-device ``argument_bytes`` must equal, byte for byte, the sum
over the step's inputs of JAX's ``NamedSharding.shard_shape`` bytes on a
``jax.sharding.AbstractMesh``: params in the cell's layout, AdamW's state
(train) or the cache (serving), and the batch. The record carries the JAX
record's keys; ``run_cell``'s escalations are replayed against the JAX
``run_cell`` under the JAX budgets.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.ARCHS
KINDS = ("train", "prefill", "decode")
# the JAX record's keys (repro/launch/dryrun.py's lower_cell)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "microbatches", "lower_s",
               "compile_s", "memory", "cost", "collectives", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes",
               "per_device_total"}
COLL_KEYS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "count", "total"}


def _jax_shard_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, JNamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(s.shard_shape(tuple(leaf.shape)))
               * leaf.dtype.itemsize for leaf, s in zip(leaves, shs))


def _jax_argument_bytes(cfg, cell, mesh, *, serving):
    """Per-device bytes of the cell's inputs in JAX's layout."""
    params = JM.param_shapes(cfg)
    total = _jax_shard_bytes(params, JSH.param_shardings(params, mesh,
                                                         serving=serving))
    batch = JS.input_specs(cfg, cell)
    total += _jax_shard_bytes(batch, JSH.batch_shardings(batch, mesh))
    if cell.kind == "train":
        opt = JAdamW().state_shapes(params)
        for f in ("m", "v", "master"):
            total += _jax_shard_bytes(getattr(opt, f), JSH.param_shardings(
                getattr(opt, f), mesh))
        total += opt.step.dtype.itemsize               # replicated scalar
    else:
        cache = jax.eval_shape(lambda: JM.init_cache(
            cfg, cell.global_batch, cell.seq_len))
        total += _jax_shard_bytes(cache, JSH.decode_cache_shardings(cache,
                                                                    mesh))
    return total


def _check_record(rec):
    assert RECORD_KEYS <= set(rec)
    assert MEMORY_KEYS <= set(rec["memory"])
    assert set(rec["cost"]) == {"global_flops", "global_bytes"}
    assert set(rec["collectives"]) == COLL_KEYS
    m = rec["memory"]
    assert m["per_device_total"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["temp_bytes"] > 0 and m["code_bytes"] == 0
    assert rec["cost"]["global_flops"] > 0 and rec["cost"]["global_bytes"] > 0
    r = rec["roofline"]
    assert r["per_device_arg_bytes"] == m["argument_bytes"]
    assert r["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_on_2x4_matches_jax_layout(arch, kind):
    """A SMOKE config at a cell of the kind (B=8, S=64, as
    tests/test_sharding.py's small-mesh dry run) on a (2, 4) abstract
    mesh: the record has the JAX keys and its argument bytes are JAX's
    exactly."""
    name = f"smoke_{kind}"
    tmesh = TMESH.AbstractMesh((2, 4), ("data", "model"))
    rec = TD.lower_cell(arch, TS.ShapeCell(name, kind, 64, 8), tmesh,
                        cfg_override=tconfigs.get_smoke(arch))
    _check_record(rec)
    assert (rec["mesh"], rec["chips"], rec["shape"]) == ("2x4", 8, name)
    cell = JS.ShapeCell(name, kind, 64, 8)
    jmesh = JAbstractMesh((2, 4), ("data", "model"))
    want = _jax_argument_bytes(jconfigs.get_smoke(arch), cell, jmesh,
                               serving=kind == "decode")
    assert rec["memory"]["argument_bytes"] == want


def test_full_size_decode_on_16x16_matches_jax_layout():
    """qwen2.5-3b at its published config, decode_32k on the production
    mesh: argument bytes equal to JAX's; the weight-stationary layout
    (no gathers), the KV split over data and model."""
    mesh = TMESH.make_production_mesh()
    rec, ok = TD.run_cell("qwen2.5-3b", "decode_32k", mesh, save=False,
                          verbose=False)
    assert ok, rec.get("traceback")
    _check_record(rec)
    assert (rec["mesh"], rec["chips"]) == ("16x16", 256)
    jmesh = JAbstractMesh((16, 16), ("data", "model"))
    want = _jax_argument_bytes(jconfigs.get_config("qwen2.5-3b"),
                               JS.SHAPES["decode_32k"], jmesh, serving=True)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["collectives"]["all-gather"] == 0
    assert "weight_stationary" not in rec


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_trace_of_two_microbatches_is_exact(arch):
    """``lower_cell`` traces memory at 4 microbatches through 2 of the same
    size (the later ones repeat the second's live storages): its temp
    bytes equal those of a trace through all 4."""
    from repro_torch.models import model as TMDL
    from repro_torch.training.optimizer import AdamW as TAdamW
    cfg = tconfigs.get_smoke(arch)
    cell = TS.ShapeCell("smoke_train", "train", 64, 16)
    params = TMDL.param_shapes(cfg)
    opt = TAdamW()
    full = TD._trace(TD._cell_step(cfg, cell, opt, 4), params,
                     opt.state_shapes(params), TS.input_specs(cfg, cell),
                     flops=False, nbytes=False, live=True)[3]
    rec = TD.lower_cell(arch, cell, TMESH.AbstractMesh((1, 1), ("data",
                                                               "model")),
                        cfg_override=cfg, microbatches=4, costs=False)
    assert rec["memory"]["temp_bytes"] == full > 0


def test_live_bytes_bound_the_allocators_blocks():
    """The trace's allocated bound adds each live storage's block slack
    (512 bytes, and 1 MiB more above 1 MiB) at the peak of the two, and
    a freed storage's slack goes with it; a record carries it as
    ``temp_alloc_slack``."""
    def step(params, state, batch):
        big = torch.empty(2**19 + 1, device="meta")      # 2 MiB + 4 B
        small = torch.empty(10, device="meta")
        del big
        return small + 1

    x = torch.empty(4, device="meta")
    peak, alloc_peak = TD._trace(step, {"x": x}, {}, {}, flops=False,
                                 nbytes=False, live=True)[3:]
    assert peak == 4 * (2**19 + 1) + 40
    assert alloc_peak == peak + 2 * TD.ALLOC_ROUND + TD.ALLOC_LARGE
    assert TD.block_slack(TD.ALLOC_LARGE) == TD.ALLOC_ROUND
    cfg = tconfigs.get_smoke("qwen2.5-3b")
    rec = TD.lower_cell("qwen2.5-3b", TS.ShapeCell("smoke_train", "train",
                                                   32, 2),
                        TMESH.AbstractMesh((1, 1), ("data", "model")),
                        cfg_override=cfg, costs=False)
    assert rec["memory"]["temp_alloc_slack"] >= TD.ALLOC_ROUND


class _FakeJaxMesh:
    """What the JAX ``run_cell`` reads of a mesh (its name)."""
    def __init__(self, shape, axes):
        import numpy as np
        self.devices = np.empty(shape)
        self.axis_names = axes


def _stub_memory(totals):
    """A ``lower_cell`` stand-in: the record of (kind, microbatches,
    serving layout) from ``totals``, its costs tagged by microbatches."""
    calls = []

    def memory(arch, shape_name, microbatches, serving_layout):
        calls.append((microbatches, serving_layout))
        total = totals[(microbatches, serving_layout)]
        return {"arch": arch, "shape": shape_name, "mesh": "16x16",
                "microbatches": microbatches, "lower_s": 0.0,
                "compile_s": 0.0,
                "memory": {"per_device_total": total, "temp_bytes": total,
                           "argument_bytes": 0},
                "cost": {"mb": microbatches},
                "collectives": {"mb": microbatches},
                "roofline": {"mb": microbatches, "compute_s": 0.0,
                             "memory_s": 0.0, "collective_s": 0.0,
                             "dominant": "memory", "useful_flop_frac": 0.0}}
    return memory, calls


GIB = 2**30
ESCALATIONS = {
    # train: over budget at 1 microbatch, fits at 2
    ("qwen2.5-3b", "train_4k"): {(1, None): 40 * GIB, (2, None): 15 * GIB,
                                 (4, None): 9 * GIB},
    # train: over at 1, 2 and 4 (the 4-microbatch record kept)
    ("qwen3-32b", "train_4k"): {(1, None): 90 * GIB, (2, None): 50 * GIB,
                                (4, None): 30 * GIB},
    # decode: the serving layout over, the FSDP one smaller
    ("arctic-480b", "decode_32k"): {(1, None): 20 * GIB,
                                    (1, False): 12 * GIB},
    # decode: over in both, the FSDP one larger: the serving one kept
    ("gemma3-27b", "decode_32k"): {(1, None): 20 * GIB,
                                   (1, False): 25 * GIB},
    # fits: no escalation
    ("rwkv6-3b", "prefill_32k"): {(1, None): 4 * GIB},
}


@pytest.mark.parametrize("cell", list(ESCALATIONS), ids=lambda c: c[1])
def test_run_cell_escalation_replays_jax(cell, monkeypatch):
    """``run_cell``'s escalations under the JAX budgets (16 GiB, 6e9
    weight bytes) decide as the JAX ``run_cell`` does on the same memory
    totals: the calls made, the record kept, its costs from the first."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD     # sets XLA_FLAGS on import
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    arch, shape_name = cell
    totals = ESCALATIONS[cell]

    jmem, jcalls = _stub_memory(totals)
    monkeypatch.setattr(JD, "lower_cell", lambda a, s, m, microbatches=1,
                        serving_layout=None, exact_costs=True:
                        (jmem(a, s, microbatches, serving_layout), None))
    jrec, jok = JD.run_cell(arch, shape_name,
                            _FakeJaxMesh((16, 16), ("data", "model")),
                            save=False, verbose=False)
    tmem, tcalls = _stub_memory(totals)
    monkeypatch.setattr(TD, "lower_cell", lambda a, s, m, microbatches=1,
                        serving_layout=None, exact_costs=True, costs=True,
                        serving_budget=None:
                        tmem(a, s, microbatches, serving_layout))
    trec, tok = TD.run_cell(arch, shape_name, TMESH.make_production_mesh(),
                            save=False, verbose=False,
                            hbm_budget=JD.HBM_BUDGET,
                            serving_budget=JD.SERVING_WEIGHT_BUDGET)
    assert jok and tok
    assert tcalls == jcalls
    assert trec == jrec


def test_cli_one_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch --shape --no-save``:
    the cell's OK line and the summary, nothing written."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--no-save"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(ln.startswith("[16x16] qwen2.5-3b") and " OK  mem/dev=" in ln
               for ln in lines), out.stdout
    assert "dry-run summary: 1 ok, 0 failed, 0 skipped" in out.stdout
    assert not list(tmp_path.iterdir())
