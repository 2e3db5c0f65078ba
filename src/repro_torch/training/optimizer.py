"""AdamW with fp32 master weights and global-norm clipping (port of
``repro/training/optimizer.py``).

The same defaults, schedule (warmup, then cosine or constant), clip
``min(1, max_grad_norm / (gnorm + 1e-9))``, bias correction, decoupled
weight decay and fp32 master copy (when a param is not fp32), in the same
order of operations. ``update`` returns new param tensors and never writes
the ones it was given, so the leaves autograd held stay as they were.
The moments ``m`` and ``v`` are the optimizer's own buffers and are
updated in place: at qwen2.5-3b's full width in fp32 a second copy of
both (24.7 GB) beside the params, their update and the gradients would
not fit an 80 GB card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any
    master: Any          # fp32 copy, or {} when every param is fp32


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"          # "cosine" | "constant"
    total_steps: int = 10_000

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp((step + 1) / max(1, self.warmup_steps), max=1.0)
        if self.schedule == "cosine":
            t = torch.clamp((step - self.warmup_steps)
                            / max(1, self.total_steps - self.warmup_steps),
                            0, 1)
            decay = 0.5 * (1 + torch.cos(math.pi * t))
        else:
            decay = 1.0
        return self.lr * warm * decay

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        needs_master = any(p.dtype != torch.float32 for p in leaves)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
            master=(tree_map(lambda p: p.detach().float().clone(), params)
                    if needs_master else {}))

    def update(self, grads, state: AdamWState, params):
        """(new params, new state, gnorm). ``state.m``/``state.v`` are
        written in place and carried into the new state."""
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
            scale = torch.clamp(self.max_grad_norm / (gnorm + 1e-9),
                                max=1.0)
            lr = self._lr(state.step)
            t = state.step.float() + 1.0
            bc1 = 1.0 - self.b1 ** t
            bc2 = 1.0 - self.b2 ** t
            base = state.master if state.master else params

            def upd(g, m, v, p):
                g = g.float() * scale
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
                step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                pf = p.float()
                return pf - lr * (step + self.weight_decay * pf)

            new_master = tree_map(upd, grads, state.m, state.v, base)
            new_params = tree_map(lambda pf, p: pf.to(p.dtype), new_master,
                                  params)
        new_state = AdamWState(step=state.step + 1, m=state.m, v=state.v,
                               master=new_master if state.master else {})
        return new_params, new_state, gnorm

    def state_shapes(self, param_shapes) -> AdamWState:
        """``init``'s state as meta tensors (shapes and dtypes, no
        memory), for any tree of tensors."""
        meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                              device="meta"), param_shapes)
        return self.init(meta)


def state_shardings(state, mesh):
    """Shardings of an AdamW state tree (``AdamW.state_shapes``): the step
    replicated, ``m``/``v``/``master`` laid out as the params they mirror
    (``param_shardings``), as the reference's dry run lays them out."""
    from repro_torch.parallel import sharding as SH
    return state._replace(step=SH.NamedSharding(mesh, SH.P()),
                          m=SH.param_shardings(state.m, mesh),
                          v=SH.param_shardings(state.v, mesh),
                          master=SH.param_shardings(state.master, mesh))
