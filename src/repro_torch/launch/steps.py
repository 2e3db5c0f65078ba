"""Step builders (port of ``repro/launch/steps.py``): train_step /
prefill_step / decode_step / forward per config.

A batch is a dict of numpy arrays or tensors; they go to the params'
device. The train step's gradients come from ``torch.autograd.grad`` of
``lm_loss`` over the param tree's leaves (fresh leaves that share the
params' storage, so the caller's tensors are never marked or written).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_loss
from repro_torch.training.optimizer import AdamW
from repro_torch.training.tree import tree_leaves, tree_unflatten


def batch_to(batch: Dict[str, Any], device: torch.device):
    """The batch's arrays as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads) of ``lm_loss`` at ``params``; a leaf the
    loss does not reach gets a zero gradient, as JAX's."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        req = [t.detach().requires_grad_() for t in leaves]
        loss, metrics = lm_loss(tree_unflatten(params, req), cfg, batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1):
    """microbatches > 1 = gradient accumulation: the global batch is
    split and processed sequentially, fp32 gradient sums divided by the
    count, loss and aux averaged, as the JAX step's ``lax.scan``."""

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, _device_of(params))
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)
        else:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + v.shape[1:]) for k, v in batch.items()}
            gsum = lsum = auxsum = None
            for i in range(microbatches):
                l, m, g = loss_and_grads(cfg, params,
                                         {k: v[i] for k, v in mb.items()})
                g = [x.float() for x in tree_leaves(g)]
                if gsum is None:
                    gsum = [torch.zeros_like(x) for x in g]
                    lsum = torch.zeros((), dtype=torch.float32,
                                       device=l.device)
                    auxsum = torch.zeros_like(lsum)
                gsum = [a + x for a, x in zip(gsum, g)]
                lsum, auxsum = lsum + l, auxsum + m["aux"]
            grads = tree_unflatten(params, [g / microbatches for g in gsum])
            loss = lsum / microbatches
            metrics = {"ce": loss, "aux": auxsum / microbatches}
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, cache, batch):
        batch = batch_to(batch, _device_of(params))
        if cfg.is_encoder_decoder:
            return MDL.prefill(params, cfg, batch["tokens"], cache,
                               batch["frame_embeds"])
        return MDL.prefill(params, cfg, batch["tokens"], cache,
                           batch.get("patch_embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        batch = batch_to(batch, _device_of(params))
        return MDL.decode_step(params, cfg, batch["tokens"], cache)
    return decode_step


def make_forward(cfg: ModelConfig):
    def fwd(params, batch):
        batch = batch_to(batch, _device_of(params))
        if cfg.is_encoder_decoder:
            return MDL.forward(params, cfg, batch["tokens"],
                               batch["frame_embeds"])[0]
        return MDL.forward(params, cfg, batch["tokens"],
                           batch.get("patch_embeds"))[0]
    return fwd
