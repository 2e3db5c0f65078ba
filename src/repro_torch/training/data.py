"""Synthetic sharded token pipeline.

Deterministic, seekable token stream (restartable from a step index — the
checkpoint/restore path needs bit-identical batches after restart), with
host-sharded loading: each data-parallel host materializes only its own
batch shard, as a real multi-pod input pipeline would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 1234


class SyntheticTokenStream:
    """Zipf-ish token stream; batch(step) is a pure function of (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # zipf-like unigram distribution (heavy head, long tail)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int, model_cfg: Optional[ModelConfig] = None
              ) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        toks = rng.choice(c.vocab_size, size=(c.global_batch, c.seq_len + 1),
                          p=self.p).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if model_cfg is not None and model_cfg.is_encoder_decoder:
            out["frame_embeds"] = rng.standard_normal(
                (c.global_batch, model_cfg.encoder_seq_len,
                 model_cfg.d_model)).astype(np.float32)
        if model_cfg is not None and model_cfg.num_patch_tokens:
            out["patch_embeds"] = rng.standard_normal(
                (c.global_batch, model_cfg.num_patch_tokens,
                 model_cfg.d_model)).astype(np.float32)
        return out

    def host_shard(self, step: int, host_index: int, host_count: int,
                   model_cfg: Optional[ModelConfig] = None):
        """Per-host slice of the global batch (sharded ingestion)."""
        full = self.batch(step, model_cfg)
        per = self.cfg.global_batch // host_count
        lo = host_index * per
        return {k: v[lo:lo + per] for k, v in full.items()}

    def iterate(self, start_step: int = 0,
                model_cfg: Optional[ModelConfig] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, model_cfg)
            step += 1
