"""Build the port's CUDA kernels with ``nvcc``, load them with ctypes,
and check what their wrappers pass in.

Each kernel package keeps its source under ``csrc/<name>.cu`` with a
plain ``extern "C"`` interface. On first use the source is compiled for
Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout; the hash is of the source, so an edit rebuilds and a
stale library is never loaded. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source with the CUDA toolkit")


def target(name: str) -> Path:
    """The built library of ``name`` (named by its source's hash)."""
    digest = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once. Returns the build seconds of each one compiled;
    ``ptxas`` output goes to ``build/kernels/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs.append((name, out, tmp, log, time.monotonic(),
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    seconds: Dict[str, float] = {}
    failed = []
    for name, out, tmp, log, t0, proc in procs:
        rc = proc.wait()
        log.close()
        seconds[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}): "
                          + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(target(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def rows_aligned(t: torch.Tensor) -> bool:
    """The kernels load rows with 16-byte vectors: the base pointer and the
    batch/sequence/head strides must keep every row 16-byte aligned."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % per == 0
                                          for st in t.stride()[:3])
