"""Checkpoints in the JAX package's on-disk format (port of
``repro/training/checkpoint.py``).

Every N steps each leaf of (params, opt_state) is written as a ``.npy``
named by its tree path under ``step_%08d/``, beside a ``manifest.json``;
the directory is written under a ``.tmp_*`` name and renamed, so a
partial write is never a checkpoint. A checkpoint of either package
restores in the other.

bfloat16 leaves: the JAX package saves an ``ml_dtypes`` array, whose
``.npy`` header names a 2-byte void (``'<V2'``), and numpy cannot cast
that back (ROADMAP R10). The port writes the same words under the header
``'bfloat16'``, which ``np.load`` reads as bfloat16 wherever ``ml_dtypes``
is imported (as under JAX), and reads either header itself by the
manifest's dtype, from the raw 2-byte words, so it needs no
``ml_dtypes``. ``shardings=`` becomes ``device=``: one card, no mesh.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import struct
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    elif hasattr(tree, "_fields"):          # NamedTuple (opt state)
        for f in tree._fields:
            yield from _flatten(getattr(tree, f),
                                f"{prefix}/{f}" if prefix else f)
    else:
        yield prefix, tree


def _save_leaf(path: Path, leaf: torch.Tensor) -> Dict[str, Any]:
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "bfloat16", "fortran_order": False,
                    "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        return {"dtype": "bfloat16", "shape": list(t.shape)}
    arr = t.numpy()
    np.save(path, arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape)}


def _read_words(path: Path) -> np.ndarray:
    """The 2-byte words of a bfloat16 ``.npy``, whatever its header calls
    them; the header is parsed here since numpy knows neither name
    without ``ml_dtypes``."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        size = struct.calcsize("<H" if major == 1 else "<I")
        (hlen,) = struct.unpack("<H" if major == 1 else "<I", f.read(size))
        header = ast.literal_eval(f.read(hlen).decode("latin1"))
        words = np.fromfile(f, dtype="<u2")
    shape = tuple(header["shape"])
    if header["descr"] not in ("<V2", "|V2", "bfloat16"):
        raise ValueError(f"{path}: a bfloat16 leaf with header "
                         f"{header['descr']!r}")
    return words.reshape(shape, order="F" if header["fortran_order"]
                         else "C")


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.ascontiguousarray(_read_words(path)).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(np.load(path))


def save_checkpoint(ckpt_dir: Path, step: int, params, opt_state=None,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Atomic checkpoint: write to tmp dir, then rename."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = opt_state
    for root, tree in trees.items():
        for path, leaf in _flatten(tree, root):
            fname = path.replace("/", "__") + ".npy"
            manifest["leaves"].append({"path": path, "file": fname,
                                       **_save_leaf(tmp / fname, leaf)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: Path, step: int, params_tmpl,
                       opt_tmpl=None, *, device: DeviceLike = None):
    """Restore into the templates' structure and dtypes (templates may
    be meta tensors, as ``AdamW.state_shapes`` gives), on ``device``.
    Returns (step, params, opt_state or None, extra)."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {e["path"]: e for e in manifest["leaves"]}

    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
            return type(t)(walk(v, f"{prefix}/{i}") for i, v in enumerate(t))
        if hasattr(t, "_fields"):
            return type(t)(**{f: walk(getattr(t, f), f"{prefix}/{f}")
                              for f in t._fields})
        e = flat[prefix]
        return _load_leaf(d / e["file"], e["dtype"]).to(device=dev,
                                                         dtype=t.dtype)

    params = walk(params_tmpl, "params")
    opt = walk(opt_tmpl, "opt") if opt_tmpl is not None else None
    return manifest["step"], params, opt, manifest.get("extra", {})
