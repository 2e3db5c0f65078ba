"""Assigned input-shape cells and per-arch applicability (port of
``repro/configs/shapes.py``).

Four LM shape cells per arch (40 total):
    train_4k     seq 4096   batch 256   -> train_step
    prefill_32k  seq 32768  batch 32    -> prefill_step
    decode_32k   KV 32768   batch 128   -> decode_step (one new token)
    long_500k    KV 524288  batch 1     -> decode_step, sub-quadratic only

Skips (recorded in DESIGN.md §Arch-applicability):
    long_500k only runs for archs with a sub-quadratic mechanism
    (recurrentgemma, gemma3 5:1 local:global, rwkv6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# archs allowed to run long_500k (sub-quadratic history mechanism)
LONG_OK = {"recurrentgemma-2b", "gemma3-27b", "rwkv6-3b"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_OK
    return True


def applicable_cells(arch: str):
    return [s for s in SHAPES if cell_applicable(arch, s)]


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a shape cell.

    No allocation — the dry run traces against these directly.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {}
        if cfg.is_encoder_decoder:
            # encoder frames + teacher-forced decoder tokens
            specs["frame_embeds"] = sds((B, S, cfg.d_model), cfg.adtype)
            specs["tokens"] = sds((B, S), i32)
            specs["labels"] = sds((B, S), i32)
        elif cfg.num_patch_tokens:
            P = cfg.num_patch_tokens
            specs["patch_embeds"] = sds((B, P, cfg.d_model), cfg.adtype)
            specs["tokens"] = sds((B, S - P), i32)
            specs["labels"] = sds((B, S - P), i32)
        else:
            specs["tokens"] = sds((B, S), i32)
            specs["labels"] = sds((B, S), i32)
        return specs

    if shape.kind == "prefill":
        specs = {}
        if cfg.is_encoder_decoder:
            specs["frame_embeds"] = sds((B, S, cfg.d_model), cfg.adtype)
            specs["tokens"] = sds((B, S), i32)
        elif cfg.num_patch_tokens:
            P = cfg.num_patch_tokens
            specs["patch_embeds"] = sds((B, P, cfg.d_model), cfg.adtype)
            specs["tokens"] = sds((B, S - P), i32)
        else:
            specs["tokens"] = sds((B, S), i32)
        return specs

    # decode: one new token against a cache of size seq_len
    return {"tokens": sds((B,), i32)}
