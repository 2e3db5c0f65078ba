"""The control's precision: fp8 (e4m3) operands for every linear layer.

The configurations serve bf16; the step below it that a later change
might take is fp8 matrix products (the card's fp8 tensor cores). The
control rounds both operands of each projection and of the output head to
e4m3 with a scale per row of the activations and per output column of the
weight (each scaled so its largest magnitude maps to 448), then multiplies
in fp32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: bool) -> torch.Tensor:
    """x (rows, k) @ w (k, n) in fp32; with ``quant`` both operands in
    e4m3 first (x per row, w per output column)."""
    if quant:
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w
