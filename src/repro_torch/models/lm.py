"""LM head for training: cross-entropy loss (fp32, z-loss), port of
``repro/models/lm.py``.

The training loss is chunked over the sequence: logits for one chunk of
``CE_CHUNK`` positions at a time are computed, reduced to (nll, z-loss)
partials and dropped. Each chunk runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint(..., nothing_saveable)``: the backward recomputes a
chunk's (B, C, vocab) logits, so they are never kept. JAX's
``logical_constraint`` on the logits has no counterpart on one device and
is left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import model as MDL

CE_CHUNK = 512


def _chunk_nll(table, xc, labels, mask, softcap, z_loss):
    """One chunk: xc (B,C,d) -> (sum nll, sum mask). Never keeps logits."""
    logits = torch.einsum("bsd,vd->bsv", xc, table)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    m = mask.float()
    return torch.sum(nll * m), torch.sum(m)


def chunked_cross_entropy(table, x, labels, mask=None, softcap=0.0,
                          z_loss=1e-4, chunk=CE_CHUNK):
    """x: (B,S,d) final hidden; table: (V,d). Returns mean masked nll."""
    B, S, d = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S + pad, chunk):
        s, c = checkpoint(_chunk_nll, table, x[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                          softcap, z_loss, use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def cross_entropy(logits, labels, mask=None, z_loss=1e-4):
    """Direct CE on materialized logits (eval / small paths)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params, cfg, batch, aux_weight=0.01):
    """batch: {"tokens", "labels", optional "mask", "frame_embeds",
    "patch_embeds"} tensors. Returns (loss, metrics)."""
    prefix = batch.get("patch_embeds")
    if cfg.is_encoder_decoder:
        feats, aux = MDL.forward_features(params, cfg, batch["tokens"],
                                          batch["frame_embeds"])
    else:
        feats, aux = MDL.forward_features(params, cfg, batch["tokens"],
                                          prefix)
    labels = batch["labels"]
    mask = batch.get("mask")
    if prefix is not None:
        # image-prefix positions carry no labels; score text tail only
        feats = feats[:, prefix.shape[1]:]
    table = MDL.unembed_table(params)["table"]
    ce = chunked_cross_entropy(table, feats, labels, mask,
                               softcap=cfg.logit_softcap)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}
