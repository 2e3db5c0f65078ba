"""Worker agent (port of ``repro/serving/server.py``): one serving cell —
hosts engines, heartbeats, fails.

``load()`` draws a variant's params on the device and warms its engine;
that wall-clock time IS the measured cold-load cost, the analogue of the
paper's Fig. 2b loads. ``submit()`` prefills on the caller's thread and
leaves batched decode to the worker thread, as in the JAX package.

The weights are seeded with ``zlib.crc32`` of the variant name, so a
variant loads the same weights in every process. (The JAX worker seeds
with the salted ``hash()``, which differs between processes.)

A dead cell raises ``WorkerDown``, and only that: the testbed treats it
as "the server died mid-load", while any other exception (a kernel that
fails to build or launch, an out-of-memory error, a bad config) is a
fault it reports. An exception from a decode step on the worker thread
is kept in ``errors`` instead of ending the thread silently.

A cell also holds tensor-parallel weight slices for the testbed's shard
plane (`serving/shard.py`): ``shard_store`` keeps them on the cell's
device, as its engines are, and ``kill()`` drops them with the engines.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import zlib
from typing import Dict, List, Optional

import torch

from repro_torch import trace
from repro_torch.core.heartbeat import FailureDetector
from repro_torch.core.variants import Application, Variant
from repro_torch.device import DeviceLike, generator_for, resolve_device
from repro_torch.models import model as MDL
from repro_torch.serving.engine import InferenceEngine, Request


class WorkerDown(RuntimeError):
    """The serving cell is dead (killed before or during the call)."""


def variant_seed(name: str) -> int:
    """Stable per-variant weight seed (same in every process)."""
    return zlib.crc32(name.encode()) % (2**31)


def draw_params(variant: Variant, device: torch.device):
    """The variant's weights as every cell draws them: seeded by its name,
    drawn on ``device`` (the same bits wherever they are drawn again)."""
    cfg = variant.config
    if cfg is None:
        raise ValueError(f"variant {variant.name} has no model config")
    gen = generator_for(device, variant_seed(variant.name))
    with torch.inference_mode():
        return MDL.init_params(gen, cfg, device=device)


class WorkerServer:
    """Thread-backed serving cell with heartbeat + engine hosting."""

    def __init__(self, server_id: str, detector: FailureDetector, *,
                 heartbeat_s: float = 0.020, batch_slots: int = 2,
                 max_len: int = 96, device: DeviceLike = None,
                 errors: Optional[List[str]] = None):
        self.device = resolve_device(device)
        self.id = server_id
        self.detector = detector
        self.heartbeat_s = heartbeat_s
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.engines: Dict[str, InferenceEngine] = {}     # variant -> engine
        self.cold_store: Dict[str, Variant] = {}          # on "disk"
        self.shard_store: Dict[str, object] = {}          # TP slices (HBM)
        self._alive = threading.Event()
        self._alive.set()
        self._threads = []
        self._lock = threading.Lock()
        self._work = queue.Queue()
        # one line per exception raised by queued work (a decode step) on
        # the worker thread; the testbed passes the list it reports
        self.errors: List[str] = errors if errors is not None else []
        # submits refused because every batch slot of the engine was busy
        self.refused = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        wk = threading.Thread(target=self._serve_loop, daemon=True)
        hb.start()
        wk.start()
        self._threads = [hb, wk]
        return self

    def kill(self):
        """Crash-failure injection: heartbeats stop, engines vanish."""
        self._alive.clear()
        with self._lock:
            self.engines.clear()
            self.shard_store.clear()

    def revive(self):
        """Rejoin after a crash: the node returns EMPTY (engines were
        lost) but its cold store (disk) survived; heartbeats resume."""
        if self._alive.is_set():
            return self
        self._alive.set()
        return self.start()

    def join(self, timeout: float = 2.0):
        """Wait for the worker's threads to exit (after kill()), then for
        the device, so no kernel launched by them is still in flight at
        interpreter teardown."""
        for t in self._threads:
            t.join(timeout=timeout)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def alive(self) -> bool:
        return self._alive.is_set()

    def _heartbeat_loop(self):
        while self._alive.is_set():
            self.detector.beat(self.id)
            time.sleep(self.heartbeat_s)

    def _serve_loop(self):
        while True:
            try:
                fn = self._work.get(timeout=0.05)
            except queue.Empty:
                if not self._alive.is_set():
                    return
                continue
            if not self._alive.is_set():
                return
            try:
                fn()
            except Exception:                  # noqa: BLE001
                traceback.print_exc()
                self.errors.append(
                    f"decode step on {self.id}: "
                    f"{traceback.format_exc(limit=0).strip()}")

    # -- model management (Triton Load/Unload analogue) -----------------------
    def stage_cold(self, app: Application, variant: Variant):
        """Cold replica: weights on disk/host only."""
        self.cold_store[variant.name] = variant

    def load(self, app: Application, variant: Variant,
             warm: bool = True) -> float:
        """Draw params on the device + warm the engine; returns wall-clock
        load seconds."""
        if not self.alive:
            raise WorkerDown(f"{self.id} is down")
        t0 = time.monotonic()
        with trace.span("load.draw") if trace.ON else trace.OFF:
            params = draw_params(variant, self.device)
            eng = InferenceEngine(variant.config, params,
                                  batch_slots=self.batch_slots,
                                  max_len=self.max_len, device=self.device)
        if warm:
            with trace.span("load.warmup") if trace.ON else trace.OFF:
                eng.warmup()
        if self.device.type == "cuda":
            with trace.span("load.sync") if trace.ON else trace.OFF:
                torch.cuda.synchronize(self.device)
        with self._lock:
            if not self.alive:
                raise WorkerDown(f"{self.id} died during load")
            self.engines[variant.name] = eng
        return time.monotonic() - t0

    def install(self, variant_name: str, engine: InferenceEngine):
        """Adopt a pre-built engine (tensor-parallel deployments gather
        their shard slices off-worker and install the result here)."""
        if not self.alive:
            raise WorkerDown(f"{self.id} is down")
        with self._lock:
            if not self.alive:
                raise WorkerDown(f"{self.id} died during install")
            self.engines[variant_name] = engine

    def alias(self, dst: str, src: str) -> bool:
        """Serve `src`'s resident engine under the name `dst` too
        (degraded-TP routes keep answering on the gathered engine until
        the honest rebuild swaps in). False if `src` is not resident."""
        with self._lock:
            eng = self.engines.get(src)
            if eng is None or not self.alive:
                return False
            self.engines[dst] = eng
            return True

    def host_shard(self, name: str, slice_tree) -> None:
        """Hold one TP weight slice in this cell's memory. Lost on
        kill() (unlike the cold store, which models disk)."""
        if not self.alive:
            raise WorkerDown(f"{self.id} is down")
        with self._lock:
            if not self.alive:
                raise WorkerDown(f"{self.id} died hosting a shard")
            self.shard_store[name] = slice_tree

    def shard(self, name: str):
        """The hosted slice, or None if this cell is dead/empty."""
        if not self.alive:
            return None
        with self._lock:
            return self.shard_store.get(name)

    def unload(self, variant_name: str):
        with self._lock:
            self.engines.pop(variant_name, None)

    def has(self, variant_name: str) -> bool:
        with self._lock:
            return variant_name in self.engines

    # -- serving ---------------------------------------------------------------
    def submit(self, variant_name: str, req: Request) -> bool:
        with self._lock:
            eng = self.engines.get(variant_name)
        if eng is None or not self.alive:
            return False
        if not eng.try_admit(req):
            with self._lock:
                self.refused += 1
            return False
        self._work.put(lambda: self._drain(eng))
        return True

    def _drain(self, eng: InferenceEngine):
        while eng.active_count() and self._alive.is_set():
            eng.step()
