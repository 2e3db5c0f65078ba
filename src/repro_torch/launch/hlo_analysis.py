"""Collective-byte accounting + roofline terms (port of
``repro/launch/hlo_analysis.py``; the name kept so a reader finds the
counterpart).

The port has no HLO: the dry run traces the steps eagerly on meta tensors
(``launch/dryrun.py``). So ``collective_bytes`` of the reference, which
parses the compiled program's collectives, becomes
``collective_bytes_for``, which reckons them from the layout by the rule
its docstring states. The roofline follows the reference's formulas with
one NVIDIA H100 80GB HBM3 (SXM, 700 W power limit; NVIDIA's data sheet,
dense rates) in place of the TPU chip:

    PEAK_FLOPS  989 TFLOP/s  dense bf16 on the tensor cores
    HBM_BW      3.35 TB/s    HBM3
    LINK_BW     450 GB/s     NVLink 4, one direction (900 GB/s both ways)

A mesh that spans nodes goes over the network between them, far slower
than NVLink within one, so ``collective_s`` is a lower bound there.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict

import torch

PEAK_FLOPS = 989e12          # bf16 per card (H100 SXM, 700 W)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink 4, one direction

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

FSDP_AXES = ("pod", "data")


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def collective_bytes_for(cfg, shape, shardings, mesh) -> Dict[str, int]:
    """Collective bytes of one step of ``shape`` (a ``ShapeCell``) with the
    params laid out by ``shardings`` (``param_shardings``' tree) on
    ``mesh``, under the JAX keys, each a global total (one device's bytes
    times the chips, as the reference scales its per-device program).

    The rule, per device; each op counted at its output, as the reference
    counts a collective in HLO:

    * all-gather: every param leaf split over an FSDP axis (``pod`` /
      ``data``) of size > 1 is gathered to its TP block (its shard with the
      FSDP axes dropped) in the forward, and again in a train step's
      backward;
    * reduce-scatter: in a train step, each such leaf's gradient, to its
      shard;
    * all-reduce: with ``model`` over 1, two a block (attention out, FFN
      out, Megatron's g) of the ``(B/dp)·S·d_model`` activations in the
      activation dtype, S = 1 at a decode step; a train step's backward
      adds two a block more (the conjugate f). B/dp is the batch's shard;
    * all-to-all, collective-permute: none (no rule places an expert
      exchange or a ring).

    On a (1, 1) mesh everything is 0.
    """
    from repro_torch.configs.shapes import input_specs
    from repro_torch.models.model import param_shapes
    from repro_torch.parallel import sharding as SH
    from repro_torch.training.tree import tree_leaves

    sizes = SH._mesh_sizes(mesh)
    chips = math.prod(sizes.values())
    train = shape.kind == "train"
    out: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    out["count"] = 0
    for leaf, sh in zip(tree_leaves(param_shapes(cfg)),
                        tree_leaves(shardings)):
        fsdp = 1
        for e in sh.spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a in FSDP_AXES:
                    fsdp *= sizes[a]
        if fsdp == 1:
            continue
        tp = SH.NamedSharding(mesh, SH._drop_axes(sh.spec, set(FSDP_AXES)))
        gathers = 2 if train else 1
        out["all-gather"] += gathers * _nbytes(tp.shard_shape(leaf.shape),
                                               leaf.dtype)
        out["count"] += gathers
        if train:
            out["reduce-scatter"] += _nbytes(sh.shard_shape(leaf.shape),
                                             leaf.dtype)
            out["count"] += 1
    if sizes.get("model", 1) > 1:
        batch = input_specs(cfg, shape)
        tok = batch["tokens"]
        b_local = SH.batch_shardings(batch, mesh)["tokens"].shard_shape(
            tok.shape)[0]
        seq = 1 if shape.kind == "decode" else shape.seq_len
        n = 2 * cfg.num_layers * (2 if train else 1)
        out["all-reduce"] += n * _nbytes((b_local, seq, cfg.d_model),
                                         cfg.adtype)
        out["count"] += n
    out = {k: v * chips for k, v in out.items()}
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_flop_frac: float
    per_device_temp_bytes: float = 0.0
    per_device_arg_bytes: float = 0.0

    def to_dict(self):
        return asdict(self)


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   hlo_flops: float, hlo_bytes: float, coll_bytes: float,
                   model_flops: float, temp_bytes: float = 0.0,
                   arg_bytes: float = 0.0) -> Roofline:
    compute_s = hlo_flops / (chips * PEAK_FLOPS)
    memory_s = hlo_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes, coll_bytes=coll_bytes,
        model_flops=model_flops, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        useful_flop_frac=(model_flops / hlo_flops) if hlo_flops else 0.0,
        per_device_temp_bytes=temp_bytes, per_device_arg_bytes=arg_bytes)


def model_flops_for(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
