"""Params bridge between the JAX package's trees and the port's.

Both packages lay params out the same way (``embed`` / ``final_norm`` /
``cycles`` / ``tail``; dicts, lists and array leaves), so the bridge is a
1:1 map over the tree. It goes through numpy and never imports jax: the
caller converts JAX arrays with ``np.asarray``. bfloat16 travels as
float32, which holds every bfloat16 value exactly. KV-cache trees
(``pos`` / ``cycles`` / ``tail``) use the same two functions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16, via fp32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)      # own, writable copy


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    if hasattr(t, "full_tensor"):           # a DTensor: the whole leaf
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Numpy (or ``np.asarray``-able) tree -> torch tree on ``device``."""
    dev = resolve_device(device)
    return _map(lambda a: _leaf_to_torch(a, dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Torch tree -> numpy tree; bfloat16 leaves come back as float32, a
    DTensor leaf whole (``full_tensor``, a collective on its mesh)."""
    return _map(_leaf_to_numpy, tree)
