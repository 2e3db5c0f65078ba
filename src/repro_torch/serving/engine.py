"""Batched inference engine (port of ``repro/serving/engine.py``):
continuous batching over a slotted KV cache.

One engine = one loaded model variant on one serving cell. Requests are
admitted into free batch slots; each step() runs one decode step for all
slots (prefill on admission). Greedy sampling; per-slot position
bookkeeping lives in the model cache ("pos").

Locks: ``_lock`` guards the slot bookkeeping, as in the JAX engine.
``_model_lock`` serializes the model calls, because the cache is updated
in place: a prefill on a client thread and a decode step on the worker
thread must not interleave their writes. (The JAX engine swaps whole
cache trees instead, and a prefill that lands while a step is in flight
is lost when the step stores its result.)

Requests are text tokens only, as in the JAX engine: a patch-prefix
model (llava) is served without its prefix, and an encoder-decoder model
(whisper) loads and warms up (a decode step, no prefill) but refuses a
request, which would need frame embeddings the engine does not take.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    id: str
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 8
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None
    admitted_ns: int = 0            # set while the tracer is on

    @property
    def latency(self) -> Optional[float]:
        return None if self.done_at is None else \
            self.done_at - self.submitted_at


class InferenceEngine:
    """Slot-based continuous batching for one model instance."""

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch_slots = batch_slots
        self.max_len = max_len
        with torch.inference_mode():
            self.cache = MDL.init_cache(cfg, batch_slots, max_len,
                                        device=self.device)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.remaining: np.ndarray = np.zeros(batch_slots, np.int32)
        self.steps = 0                  # decode steps run
        self._lock = threading.Lock()
        self._model_lock = threading.Lock()

    @torch.inference_mode()
    def warmup(self, prompt_bucket: int = 8):
        """One decode and one bucketed prefill on a scratch cache, so the
        kernels are built and loaded and the allocator is warm before the
        first request (counts toward load time, the paper's Fig. 2b
        load+warmup analogue). An encoder-decoder model runs the decode
        only, as the JAX engine does."""
        with self._model_lock:
            cache = MDL.init_cache(self.cfg, self.batch_slots,
                                   prompt_bucket + 1, device=self.device)
            tok = torch.zeros((self.batch_slots,), dtype=torch.int32,
                              device=self.device)
            logits, _ = MDL.decode_step(self.params, self.cfg, tok, cache)
            if self.cfg.is_encoder_decoder:
                logits.cpu()
                return
            sub = MDL.cache_take_slot(cache, 0)
            sub["pos"] = torch.zeros((1,), dtype=torch.int32,
                                     device=self.device)
            logits, _ = MDL.prefill(
                self.params, self.cfg,
                torch.zeros((1, prompt_bucket), dtype=torch.int32,
                            device=self.device), sub)
            logits.cpu()

    # -- admission -----------------------------------------------------------
    @torch.inference_mode()
    def try_admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False if none is free. Traced
        as ``engine.prefill.upload`` (the prompt's copy to the device, which
        waits for the work queued before it on the stream) and
        ``engine.prefill``, with ``engine.prefill.enqueue`` (until the
        prefill and its cache write return) and ``engine.prefill.sync``
        (the first token's readback); the request's ``request`` span runs
        from here to the step that finishes it."""
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{self.cfg.name}: the engine serves text prompts only; an "
                "encoder-decoder request needs frame embeddings, which it "
                "does not take (as the JAX engine)")
        with self._lock:
            try:
                slot = self.slots.index(None)
            except ValueError:
                return False
            self.slots[slot] = req
            self.remaining[slot] = req.max_new_tokens
        if trace.ON:
            req.admitted_ns = trace.now()
        # single-sequence prefill into the slot (pos bookkeeping per slot)
        with trace.span("engine.prefill.upload", req=req.id) if trace.ON \
                else trace.OFF:
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                     device=self.device)[None, :]
        self._take_model_lock("req", req.id)
        try:
            with trace.span("engine.prefill", req=req.id,
                            S=prompt.shape[1]) if trace.ON else trace.OFF:
                with trace.span("engine.prefill.enqueue") if trace.ON \
                        else trace.OFF:
                    # a request starts from zero state: the slot still
                    # holds the previous request's KV and recurrent state,
                    # advanced further by every decode step it sat through
                    # empty (the JAX engine resets only pos, and its
                    # recurrent archs leak state between requests)
                    sub = MDL.cache_zero(MDL.cache_take_slot(self.cache,
                                                             slot))
                    logits, sub = MDL.prefill(self.params, self.cfg, prompt,
                                              sub)
                    MDL.cache_put_slot(self.cache, slot, sub)
                with trace.span("engine.prefill.sync") if trace.ON \
                        else trace.OFF:
                    first = int(torch.argmax(logits[0]))
            # the first token lands before the model lock is released: a
            # decode step in between would see the slot without a token,
            # feed it token 0 and advance its fresh state
            with self._lock:
                req.tokens.append(first)
                req.first_token_at = time.monotonic()
        finally:
            self._model_lock.release()
        return True

    def _take_model_lock(self, key: str, value) -> None:
        """Acquire ``_model_lock``; with the tracer on, the wait is an
        ``engine.lock_wait`` span keyed by the request or the step."""
        if not trace.ON:
            self._model_lock.acquire()
            return
        t0 = trace.now()
        self._model_lock.acquire()
        trace.record("engine.lock_wait", t0, trace.now(), **{key: value})

    def _trace_active(self, active: List[int]) -> List[int]:
        """The contexts of the slots a step decodes; each request it
        decodes for the first time ends its ``engine.first_decode_wait``
        span, from its first token to now, which holds the wait for the
        server's serve thread and for this step's lock. Call under
        ``_lock``."""
        t = trace.now()
        for i in active:
            r = self.slots[i]
            if len(r.tokens) == 1:
                trace.record("engine.first_decode_wait",
                             trace.ns(r.first_token_at), t, req=r.id)
        return [len(self.slots[i].prompt) + len(self.slots[i].tokens)
                for i in active]

    # -- decode ---------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One decode step for all active slots; returns finished reqs.
        Traced as ``engine.decode`` (its slots and their contexts), with
        ``engine.decode.upload`` (the last tokens' copy to the device,
        which waits for the work queued before it on the stream),
        ``engine.decode.enqueue`` (until ``decode_step`` and the argmax
        return) and ``engine.decode.sync`` (the tokens' readback)."""
        self._take_model_lock("step", self.steps)
        try:
            with self._lock:
                active = [i for i, r in enumerate(self.slots)
                          if r is not None and r.tokens]
                if not active:
                    return []
                last = [r.tokens[-1] if r is not None and r.tokens else 0
                        for r in self.slots]
                ctx = self._trace_active(active) if trace.ON else None
            with trace.span("engine.decode", slots=len(active),
                            contexts=ctx) if trace.ON else trace.OFF:
                with trace.span("engine.decode.upload") if trace.ON \
                        else trace.OFF:
                    tok = torch.tensor(last, dtype=torch.int32,
                                       device=self.device)
                with trace.span("engine.decode.enqueue") if trace.ON \
                        else trace.OFF:
                    logits, _ = MDL.decode_step(self.params, self.cfg, tok,
                                                self.cache)
                    nxt = torch.argmax(logits, dim=-1)
                with trace.span("engine.decode.sync") if trace.ON \
                        else trace.OFF:
                    nxt = nxt.cpu().numpy()
            self.steps += 1
            if trace.ON:
                trace.count("engine.decode_tokens", len(active))
        finally:
            self._model_lock.release()
        finished = []
        with self._lock:
            for i in active:
                req = self.slots[i]
                req.tokens.append(int(nxt[i]))
                self.remaining[i] -= 1
                if self.remaining[i] <= 0:
                    req.done_at = time.monotonic()
                    if trace.ON and req.admitted_ns:
                        trace.record("request", req.admitted_ns,
                                     trace.ns(req.done_at), req=req.id)
                    finished.append(req)
                    self.slots[i] = None
        return finished

    def active_count(self) -> int:
        with self._lock:
            return sum(r is not None for r in self.slots)
