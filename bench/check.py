"""How ``correct`` is decided: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the completed requests, drawn from the seed, is run through the plain
reference of the configuration's family (``bench/reference/<family>.py``),
each once over its prompt and the tokens it was served. For each served
token the gap is the reference's best logit at that position less the
reference's logit of the served token (0 where they agree); the number
compared is the widest gap over the sample. The sample holds the longest
request of all, a request of every other rung that served in the window,
then requests drawn from the seed while their positions fit the mix's
``check_positions``.

The control (``run.py --control 1``) reads, at the same positions, the gap
of the token that the reference computed in fp8 puts first, and is judged
by the same limit.
"""

from __future__ import annotations

import gc
import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import ladder
from .reference import weights as RW


def reference_module(family: str):
    """``bench/reference/<family>.py``, found by name."""
    return importlib.import_module(f"bench.reference.{family}")


def pick_sample(done: Sequence, seed: int, budget: int) -> List:
    """``done``: completed requests (``.idx``, ``.variant``, ``.prompt``,
    ``.tokens``). The longest of all; then, for each other rung that
    served, a request of it drawn from the seed (its shortest where none
    fits the budget); then seeded draws while ``budget`` positions last."""
    if not done:
        return []

    def size(r):
        return len(r.prompt) + len(r.tokens) - 1
    rng = np.random.default_rng([seed & (2**63 - 1), 0x636865636b])
    order = [done[int(i)] for i in rng.permutation(len(done))]
    longest = max(done, key=size)
    chosen = {longest.idx: longest}
    used = size(longest)
    for variant in sorted({r.variant for r in done} - {longest.variant}):
        mine = [r for r in order if r.variant == variant]
        fit = [r for r in mine if used + size(r) <= budget]
        r = fit[0] if fit else min(mine, key=size)
        chosen[r.idx] = r
        used += size(r)
    for r in order:
        if r.idx not in chosen and used + size(r) <= budget:
            chosen[r.idx] = r
            used += size(r)
    return sorted(chosen.values(), key=lambda r: (r.variant, r.idx))


def set_fp32_exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def gaps(config: Dict, sample: Sequence, device: torch.device,
         control: bool = False) -> List[Dict]:
    """One row per sampled request: its rung, positions and the widest gap
    of its served tokens (``served_gap``); with ``control``, also the
    widest gap of the fp8 reference's first choices (``control_gap``)."""
    set_fp32_exact()
    model = config["model"]
    ref = reference_module(config["check"]["reference"])
    rows = []
    by_variant: Dict[str, List] = {}
    for r in sample:
        by_variant.setdefault(r.variant, []).append(r)
    for variant, reqs in by_variant.items():
        dims = ladder.rung_dims(model, ladder.tag_of(variant))
        w = RW.draw_weights(dims, variant, device)
        for r in reqs:
            toks = np.concatenate([np.asarray(r.prompt, np.int64),
                                   np.asarray(r.tokens[:-1], np.int64)])
            t = torch.as_tensor(toks, device=device)
            n = len(r.tokens)
            logits = ref.forward(w, dims, t, n)
            served = torch.as_tensor(np.asarray(r.tokens, np.int64),
                                     device=device)
            best = logits.max(dim=-1).values
            g = best - logits.gather(1, served[:, None])[:, 0]
            row = {"idx": r.idx, "variant": variant,
                   "positions": int(t.numel()), "tokens": n,
                   "served_gap": float(g.max())}
            if control:
                low = ref.forward(w, dims, t, n, quant=True)
                pick = low.argmax(dim=-1)
                cg = best - logits.gather(1, pick[:, None])[:, 0]
                row["control_gap"] = float(cg.max())
                del low
            rows.append(row)
            del logits
        del w
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def widest(rows: Sequence[Dict], key: str) -> Optional[float]:
    vals = [r[key] for r in rows if key in r]
    return max(vals) if vals else None
