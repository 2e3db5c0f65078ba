"""Mesh construction (port of ``repro/launch/mesh.py``).

Two kinds of mesh, both with named axes:

- an ``AbstractMesh``: axis names and sizes, no devices and no process
  group, the counterpart of ``jax.sharding.AbstractMesh``. The production
  meshes are abstract: they serve layout and accounting (the dry run
  needs only names and sizes), and no process owns 256 or 512 cards;
- a real mesh: a ``torch.distributed.device_mesh.DeviceMesh`` over the
  ranks of the current process group, whose shardings give DTensor
  placements.

Kept as FUNCTIONS (not module constants), so importing this module
touches no device and no process-group state.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from repro_torch.device import DeviceLike, resolve_device


class AbstractMesh:
    """Named mesh axes and their sizes; no devices."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes "
                             f"{tuple(axis_names)}")
        self.axis_sizes: Tuple[int, ...] = tuple(int(s) for s in axis_sizes)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, AbstractMesh)
                and other.axis_sizes == self.axis_sizes
                and other.axis_names == self.axis_names)

    def __hash__(self) -> int:
        return hash((self.axis_sizes, self.axis_names))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                    self.axis_sizes))
        return f"AbstractMesh({axes})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of either kind of mesh, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def mesh_name(mesh) -> str:
    """"16x16", "2x16x16": the dry run's name of a mesh."""
    return "x".join(str(s) for s in axis_sizes(mesh).values())


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """One pod = 16x16 = 256 chips; two pods = 512 chips (the reference's
    layout), as an abstract mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_mesh(shape, axes, *, device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over the current process group, whose
    world size must be ``prod(shape)``; on the card, or the CPU when
    ``device="cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a device mesh is on the card or the CPU, not "
                         f"{dev}")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group; "
                           "make_local_mesh makes one of one rank")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(device: DeviceLike = None):
    """A (1, 1) ``("data", "model")`` ``DeviceMesh`` over ``cuda:0`` (the
    CPU only when ``device="cpu"``). Without a process group it first
    makes one of one rank: NCCL (gloo on the CPU) over a ``HashStore``,
    no environment variables read."""
    import torch
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), device=dev)
