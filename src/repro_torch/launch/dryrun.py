"""Multi-pod dry run: account every (arch x shape x mesh) cell on meta
tensors (port of ``repro/launch/dryrun.py``).

For each cell this builds the full-size config, makes meta-tensor
stand-ins for params / optimizer state / caches / batch (no allocation),
lays them out on the production mesh (an ``AbstractMesh``: names and
sizes, no devices) with the port's sharding rules, traces the step
eagerly on meta tensors, and records:

  * memory — ``argument_bytes`` and ``output_bytes``: the exact per-device
    bytes of the step's inputs and outputs under the cell's shardings (the
    sum of each leaf's ``shard_shape``); ``temp_bytes``: the peak live
    bytes of the trace at one data-parallel rank's batch share with the
    weights whole — an upper bound, since no tensor-parallel split is
    applied to the activations (``temp_bytes_bound``); a train cell's
    trace runs the config's remat regions, so it holds each region's
    input and one region's recomputed activations at a time, as the
    reference's remat'd step; ``temp_alloc_slack``: how far the caching
    allocator's blocks may exceed those bytes (``block_slack`` of each
    live storage, at the peak of bytes plus slack), so that
    ``temp_bytes + temp_alloc_slack`` bounds what the card allocates;
    ``code_bytes`` 0;
  * cost — ``global_flops`` from ``torch.utils.flop_counter``'s count of
    the trace at the cell's global shapes (matmul-class operations; a
    train cell's include the backward's recomputed forward, as XLA's count
    of a remat'd HLO does), and
    ``global_bytes``, the same trace's sum of each operation's input and
    output bytes (view operations move none): an unfused count;
  * collectives — reckoned from the layout (``hlo_analysis.
    collective_bytes_for``).

On meta tensors the model takes its plain paths (as the reference's trace
takes its jnp paths; the RG-LRU and WKV-6 recurrences their kernels'
chunked plain algorithms, whose loops run over chunks, not steps), every
layer traced: there is no scan to extrapolate. Cells are independent
traces, run in a process a core. Results land in
experiments/dryrun_torch/<mesh>/<arch>__<shape>.json, beside and never
over the reference's records.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import model as MDL
from repro_torch.parallel import sharding as SH
from repro_torch.training.checkpoint import _flatten
from repro_torch.training.optimizer import AdamW, state_shardings

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (700 W power limit): the per-device budget
HBM_BUDGET = 85_017_493_504
# the reference keeps 6e9 of its 16 GiB for weight-stationary decode
# weights; the same share of the card's budget
SERVING_WEIGHT_BUDGET = HBM_BUDGET * 6e9 / (16 * 2**30)
# PyTorch's caching allocator rounds a block up to 512 bytes, and leaves
# a block over 1 MiB unsplit when the rest of its segment is 1 MiB or less
ALLOC_ROUND = 512
ALLOC_LARGE = 2**20


def _leaves(tree):
    """The leaves of a tree of dicts (sorted keys), lists, tuples and
    NamedTuples (AdamW's state), in order."""
    return [leaf for _, leaf in _flatten(tree)]


def _shard_bytes(tree, shardings) -> int:
    """Per-device bytes of ``tree`` laid out by ``shardings``."""
    leaves, shs = _leaves(tree), _leaves(shardings)
    if len(leaves) != len(shs):
        raise ValueError(f"{len(leaves)} leaves, {len(shs)} shardings")
    return sum(t.element_size() * math.prod(sh.shard_shape(t.shape))
               for t, sh in zip(leaves, shs))


def _tensors(xs):
    """The tensors among ``xs`` and the lists and tuples in it (an aten
    operation's arguments or outputs)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (t for t in x if isinstance(t, torch.Tensor))


class _Bytes(TorchDispatchMode):
    """Sums each operation's input and output tensor bytes; a view
    operation moves none."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            outs = (out,) if isinstance(out, torch.Tensor) else out
            self.total += sum(
                t.numel() * t.element_size()
                for t in _tensors((*args, *(kwargs or {}).values(), *outs)))
        return out


class _LiveBytes(TorchDispatchMode):
    """Peak bytes of the storages the traced operations create and that
    are alive at once; the storages of ``exclude`` (the arguments) are
    not counted. A storage's Python object lives as long as the storage
    (PyTorch keeps it while C++ holds the storage, as autograd's saved
    tensors do), so a weak reference to it marks the storage's end.
    ``alloc_peak`` is the peak of the same bytes plus each live storage's
    ``block_slack``: a bound on the allocator's blocks for them."""

    def __init__(self, exclude):
        super().__init__()
        self.exclude = {t.untyped_storage()._cdata for t in exclude}
        self.live = {}                  # storage key -> its weak reference
        self.now = self.peak = 0
        self.slack = self.alloc_peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors((out,) if isinstance(out, torch.Tensor) else out):
            st = t.untyped_storage()
            k = st._cdata
            if k in self.exclude or k in self.live:
                continue
            n = st.nbytes()
            self.live[k] = weakref.ref(st, lambda _, k=k, n=n: self._free(
                k, n))
            self.now += n
            self.slack += block_slack(n)
        self.peak = max(self.peak, self.now)
        self.alloc_peak = max(self.alloc_peak, self.now + self.slack)
        return out

    def _free(self, key, nbytes):
        del self.live[key]
        self.now -= nbytes
        self.slack -= block_slack(nbytes)


def block_slack(nbytes: int) -> int:
    """The most the caching allocator's block for a storage of ``nbytes``
    may exceed it: its rounding, and a large block's unsplit rest."""
    return ALLOC_ROUND + (ALLOC_LARGE if nbytes > ALLOC_LARGE else 0)


def _local_batch(batch, batch_sh):
    """The batch at one data-parallel rank's share (leading dim only)."""
    return {k: torch.empty((sh.shard_shape(v.shape)[0],) + tuple(v.shape[1:]),
                           dtype=v.dtype, device="meta")
            for (k, v), sh in zip(batch.items(), batch_sh.values())}


def _cell_step(cfg, shape, opt, microbatches):
    if shape.kind == "train":
        return make_train_step(cfg, opt, microbatches=microbatches)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape.seq_len)
    return make_decode_step(cfg)


def _state(cfg, shape, opt, params, batch_rows):
    """The step's second argument: AdamW's state, or a fresh cache of
    ``batch_rows`` rows."""
    if shape.kind == "train":
        return opt.state_shapes(params)
    return MDL.init_cache(cfg, batch_rows, shape.seq_len, device="meta")


def _trace(step, params, state, batch, *, flops: bool, nbytes: bool,
           live: bool):
    """Run ``step`` on meta tensors under the counters asked for. Returns
    (outputs, flops, bytes, peak live bytes, their allocated bound)."""
    fc = FlopCounterMode(display=False) if flops else None
    by = _Bytes() if nbytes else None
    lv = _LiveBytes(_leaves((params, state, batch))) if live else None
    with contextlib.ExitStack() as stack:
        for m in (fc, by, lv):
            if m is not None:
                stack.enter_context(m)
        out = step(params, state, batch)
    return (out, float(fc.get_total_flops()) if fc else 0.0,
            float(by.total) if by else 0.0, lv.peak if lv else 0,
            lv.alloc_peak if lv else 0)


def lower_cell(arch: str, shape_name: str, mesh, *, opt=None,
               cfg_override=None, exact_costs: bool = True,
               microbatches: int = 1, serving_layout=None,
               serving_budget: float = SERVING_WEIGHT_BUDGET,
               costs: bool = True):
    """Account one cell (``shape_name`` names one of ``SHAPES``, or is a
    ``ShapeCell``). Returns its record.

    Memory comes from the layout (arguments, outputs) and a meta trace at
    one data-parallel rank's batch share (temp); cost from a meta trace at
    the global shapes. With ``exact_costs=False`` (``--fast-costs``) the
    byte counter is skipped (``global_bytes`` 0); with ``costs=False`` the
    whole cost trace (``run_cell``'s escalations keep the first record's
    costs).
    """
    cfg = cfg_override or configs.get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    opt = opt or AdamW()
    sizes = SH._mesh_sizes(mesh)
    chips = math.prod(sizes.values())
    params = MDL.param_shapes(cfg)
    # decode: weight-stationary layout when the TP-sharded weights fit
    # the cell (kills per-token FSDP weight gathers)
    if serving_layout is None:
        serving_layout = (shape.kind == "decode"
                          and cfg.param_bytes() / sizes.get("model", 1)
                          < serving_budget)
    param_sh = SH.param_shardings(params, mesh, serving=serving_layout)
    batch = input_specs(cfg, shape)
    batch_sh = SH.batch_shardings(batch, mesh)
    state = _state(cfg, shape, opt, params, shape.global_batch)
    if shape.kind == "train":
        state_sh = state_shardings(state, mesh)
    else:
        state_sh = SH.decode_cache_shardings(state, mesh)
    step = _cell_step(cfg, shape, opt, microbatches)
    # before the trace: a step updates its cache in place
    arg_bytes = (_shard_bytes(params, param_sh)
                 + _shard_bytes(state, state_sh)
                 + _shard_bytes(batch, batch_sh))

    t0 = time.time()
    local = _local_batch(batch, batch_sh)
    rows = next(iter(local.values())).shape[0]
    # one data-parallel rank (a 1 x n mesh): the global trace is the local
    one = costs and rows == shape.global_batch and microbatches <= 2
    if one:
        mem_step, mem_state, mem_batch = step, state, batch
    else:
        # microbatches past the second repeat the second's live storages
        # (the gradient sums carried, one microbatch's activations): the
        # memory trace runs two of the same size
        mem_mb = min(microbatches, 2)
        mem_rows = rows // microbatches * mem_mb
        mem_step = _cell_step(cfg, shape, opt, mem_mb)
        mem_state = _state(cfg, shape, opt, params, mem_rows)
        mem_batch = {k: v[:mem_rows] for k, v in local.items()}
    out, flops, hbytes, temp, alloc_peak = _trace(
        mem_step, params, mem_state, mem_batch, flops=one,
        nbytes=one and exact_costs, live=True)
    t_mem = time.time() - t0
    if costs and not one:
        out, flops, hbytes, _, _ = _trace(step, params, state, batch,
                                       flops=True, nbytes=exact_costs,
                                       live=False)
    elif not costs and shape.kind != "train":
        raise ValueError("costs=False is for train cells, whose outputs do "
                         "not depend on the batch")
    t_cost = time.time() - t0 - t_mem

    if shape.kind == "train":
        out_sh = (param_sh, state_sh, SH.replicated(out[2], mesh))
    else:
        logits_sh = SH.NamedSharding(mesh, SH.filter_spec(
            SH.P(("pod", "data"), "model"), mesh, out[0].shape))
        out_sh = (logits_sh, state_sh)
    out_bytes = _shard_bytes(out, out_sh)
    coll = H.collective_bytes_for(cfg, shape, param_sh, mesh)
    roof = H.roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name(mesh),
        chips=chips, hlo_flops=flops, hlo_bytes=hbytes,
        coll_bytes=float(coll["total"]),
        model_flops=H.model_flops_for(cfg, shape),
        temp_bytes=float(temp), arg_bytes=float(arg_bytes))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "chips": chips, "microbatches": microbatches,
        "lower_s": round(t_mem, 2), "compile_s": round(t_cost, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "temp_alloc_slack": alloc_peak - temp,
            "code_bytes": 0,
            "per_device_total": arg_bytes + temp,
            "temp_bytes_bound": "upper (weights whole, no TP split of "
                                "activations)",
        },
        "cost": {"global_flops": flops, "global_bytes": hbytes},
        "collectives": coll,
        "roofline": roof.to_dict(),
    }


def run_cell(arch, shape_name, mesh, save=True, verbose=True, tag="",
             exact_costs=True, skip_existing=False, *,
             hbm_budget: float = HBM_BUDGET,
             serving_budget: float = SERVING_WEIGHT_BUDGET):
    """``lower_cell`` with the reference's escalations: a train cell over
    ``hbm_budget`` is accounted again at 2, then 4 microbatches (its
    costs kept from the first), and a decode cell over it in the FSDP
    weight layout (the smaller one kept). Returns (record, ok)."""
    if skip_existing:
        d = OUT_DIR / (mesh_name(mesh) + tag)
        f = d / f"{arch}__{shape_name}.json".replace("/", "_")
        if f.exists() and "error" not in json.loads(f.read_text()):
            if verbose:
                print(f"[{mesh_name(mesh)}] {arch:24s} {shape_name:12s} "
                      f"CACHED", flush=True)
            return json.loads(f.read_text()), True
    kw = dict(serving_budget=serving_budget)
    try:
        record = lower_cell(arch, shape_name, mesh, exact_costs=exact_costs,
                            **kw)
        if (SHAPES[shape_name].kind == "train"
                and record["memory"]["per_device_total"] > hbm_budget):
            rec1 = record
            mem1 = record["memory"]["per_device_total"]
            for mb in (2, 4):
                record = lower_cell(arch, shape_name, mesh, microbatches=mb,
                                    costs=False, **kw)
                if record["memory"]["per_device_total"] <= hbm_budget:
                    break
            record["cost"] = rec1["cost"]
            record["collectives"] = rec1["collectives"]
            record["roofline"] = dict(
                rec1["roofline"],
                per_device_temp_bytes=record["memory"]["temp_bytes"])
            record["memory_mb1_bytes"] = mem1
        if (SHAPES[shape_name].kind == "decode"
                and record["memory"]["per_device_total"] > hbm_budget):
            rec_fsdp = lower_cell(arch, shape_name, mesh,
                                  exact_costs=exact_costs,
                                  serving_layout=False, **kw)
            if (rec_fsdp["memory"]["per_device_total"]
                    < record["memory"]["per_device_total"]):
                rec_fsdp["weight_stationary"] = False
                record = rec_fsdp
        ok = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record = {"arch": arch, "shape": shape_name,
                  "mesh": mesh_name(mesh), "error": str(e),
                  "traceback": traceback.format_exc()}
        ok = False
    if verbose:
        print(cell_line(record, ok), flush=True)
    if save:
        d = OUT_DIR / (record["mesh"] + tag)
        d.mkdir(parents=True, exist_ok=True)
        fname = f"{record['arch']}__{record['shape']}.json".replace("/", "_")
        (d / fname).write_text(json.dumps(record, indent=2))
    return record, ok


def cell_line(record, ok) -> str:
    """The reference's line for one cell."""
    arch, shape_name = record["arch"], record["shape"]
    if not ok:
        return (f"[{record['mesh']}] {arch:24s} {shape_name:12s} FAILED: "
                f"{record['error'][:200]}")
    m, r = record["memory"], record["roofline"]
    return (f"[{record['mesh']}] {arch:24s} {shape_name:12s} "
            f"OK  mem/dev={m['per_device_total']/2**30:.2f}GiB "
            f"compute={r['compute_s']*1e3:.2f}ms "
            f"memory={r['memory_s']*1e3:.2f}ms "
            f"coll={r['collective_s']*1e3:.2f}ms "
            f"dom={r['dominant']} "
            f"useful={r['useful_flop_frac']:.2f} "
            f"(lower {record['lower_s']}s compile {record['compile_s']}s)")


def _cell_job(arch, shape_name, multi_pod, save, exact_costs,
              skip_existing):
    """One cell in a worker process: (record, ok), its line unprinted."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    return run_cell(arch, shape_name, mesh, save=save, verbose=False,
                    exact_costs=exact_costs, skip_existing=skip_existing)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--fast-costs", action="store_true",
                    help="skip the trace's byte counter (global_bytes 0)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    pods = ([False, True] if args.both_meshes else [args.multi_pod])
    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    jobs = [(arch, s, mp) for mp in pods for arch in archs for s in shapes]
    # the longest traces (train, then prefill) go to the workers first
    todo = sorted((j for j in jobs if cell_applicable(j[0], j[1])),
                  key=lambda j: ("train", "prefill", "decode").index(
                      SHAPES[j[1]].kind))
    # cells are independent traces: spread over the host's cores, each in
    # a fresh process, the lines printed in cell order
    workers = min(len(todo), len(os.sched_getaffinity(0)))
    opts = (not args.no_save, not args.fast_costs, args.skip_existing)
    futures = {}
    pool = (ProcessPoolExecutor(workers, mp_context=get_context("spawn"))
            if workers > 1 else None)
    try:
        for j in todo:
            futures[j] = pool.submit(_cell_job, *j, *opts) if pool else None
        n_ok = n_fail = n_skip = 0
        for arch, shape_name, mp in jobs:
            if not cell_applicable(arch, shape_name):
                name = mesh_name(make_production_mesh(multi_pod=mp))
                print(f"[{name}] {arch:24s} {shape_name:12s} "
                      f"SKIP (full-attention arch; see DESIGN.md)",
                      flush=True)
                n_skip += 1
                continue
            fut = futures[(arch, shape_name, mp)]
            record, ok = (fut.result() if fut else
                          _cell_job(arch, shape_name, mp, *opts))
            print(cell_line(record, ok), flush=True)
            n_ok += ok
            n_fail += (not ok)
    finally:
        if pool:
            pool.shutdown(cancel_futures=True)
    print(f"\ndry-run summary: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
