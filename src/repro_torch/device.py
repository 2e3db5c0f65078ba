"""Device selection for the port's entry points.

The port runs on the card. The CPU is used only when the caller asks for
it (the tests do); there is no silent fallback.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu``, or ``meta`` (shapes and dtypes, no
    memory: the dry run's accounting), only when asked for.

    Raises RuntimeError when CUDA is wanted (explicitly or by default)
    and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator_for(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator that draws on ``device``."""
    return torch.Generator(device=device).manual_seed(int(seed))
