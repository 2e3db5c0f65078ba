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
``ml_dtypes``.

The elastic restore: with ``shardings=`` / ``opt_shardings=`` (trees of
``parallel.sharding.NamedSharding`` on a ``DeviceMesh``) each leaf comes
back as a DTensor at its sharding's placements, built by every rank from
the file's full leaf sliced to its own block (no collective), so a
checkpoint written under one mesh restores onto any other. ``local_tree``
gives the local shards as plain tensors (a (1, 1) mesh's are the whole
leaves). Without them, ``device=`` places whole leaves as before.
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


def _local_block(full: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of ``full`` under ``sharding``'s placements: each
    mesh dim that shards a tensor dim takes this rank's coordinate's
    chunk of it, mesh dims in order (the major axis first)."""
    from torch.distributed.tensor import Shard
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    block = full
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            size = block.shape[p.dim] // n
            block = block.narrow(p.dim, coord[i] * size, size)
    return block


def _to_dtensor(full: torch.Tensor, sharding):
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    local = _local_block(full, sharding).contiguous().to(mesh.device_type)
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def restore_checkpoint(ckpt_dir: Path, step: int, params_tmpl,
                       opt_tmpl=None, *, device: DeviceLike = None,
                       shardings=None, opt_shardings=None):
    """Restore into the templates' structure and dtypes (templates may
    be meta tensors, as ``param_shapes`` and ``AdamW.state_shapes`` give):
    each leaf that ``shardings`` (params) or ``opt_shardings`` (the
    optimizer state) lays out as a DTensor on its mesh, every other leaf
    whole on ``device``. Returns (step, params, opt_state or None,
    extra)."""
    if shardings is None and opt_shardings is None:
        dev = resolve_device(device)
    else:          # a leaf without a sharding goes to the meshes' device
        dev = _mesh_device(shardings, opt_shardings)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {e["path"]: e for e in manifest["leaves"]}

    def rebuild(tmpl, root, shs):
        sh_leaves = dict(_flatten(shs, root)) if shs is not None else {}

        def walk(t, prefix):
            if isinstance(t, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in t.items()}
            if isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
                return type(t)(walk(v, f"{prefix}/{i}")
                               for i, v in enumerate(t))
            if hasattr(t, "_fields"):
                return type(t)(**{f: walk(getattr(t, f), f"{prefix}/{f}")
                                  for f in t._fields})
            e = flat[prefix]
            full = _load_leaf(d / e["file"], e["dtype"]).to(dtype=t.dtype)
            sh = sh_leaves.get(prefix)
            if sh is not None:
                return _to_dtensor(full, sh)
            return full.to(dev)
        return walk(tmpl, root)

    params = rebuild(params_tmpl, "params", shardings)
    opt = (rebuild(opt_tmpl, "opt", opt_shardings)
           if opt_tmpl is not None else None)
    return manifest["step"], params, opt, manifest.get("extra", {})


def _mesh_device(*trees) -> torch.device:
    """The device type of the first sharding's mesh in ``trees``: where
    a leaf without a sharding goes in a sharded restore."""
    for tree in (t for t in trees if t is not None):
        for _, sh in _flatten(tree):
            return torch.device(sh.mesh.device_type)
    raise ValueError("no sharding to place the restore on")


def local_tree(tree):
    """``tree`` with each DTensor leaf replaced by its local shard (a plain
    tensor), so an engine or a train step takes a restored tree; other
    leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(local_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v) for v in tree)
    return tree.to_local() if isinstance(tree, DTensor) else tree
