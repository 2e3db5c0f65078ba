"""Worker agent (port of ``repro/serving/server.py``): one serving cell —
hosts engines, heartbeats, fails.

``load()`` draws a variant's params on the device and warms its engine;
that wall-clock time IS the measured cold-load cost, the analogue of the
paper's Fig. 2b loads. ``submit()`` prefills on the caller's thread and
leaves batched decode to the worker thread, as in the JAX package.

The weights are seeded with ``zlib.crc32`` of the variant name, so a
variant loads the same weights in every process. (The JAX worker seeds
with the salted ``hash()``, which differs between processes.)
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from typing import Dict

import torch

from repro_torch.core.heartbeat import FailureDetector
from repro_torch.core.variants import Application, Variant
from repro_torch.device import DeviceLike, generator_for, resolve_device
from repro_torch.models import model as MDL
from repro_torch.serving.engine import InferenceEngine, Request


def variant_seed(name: str) -> int:
    """Stable per-variant weight seed (same in every process)."""
    return zlib.crc32(name.encode()) % (2**31)


class WorkerServer:
    """Thread-backed serving cell with heartbeat + engine hosting."""

    def __init__(self, server_id: str, detector: FailureDetector, *,
                 heartbeat_s: float = 0.020, batch_slots: int = 2,
                 max_len: int = 96, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.id = server_id
        self.detector = detector
        self.heartbeat_s = heartbeat_s
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.engines: Dict[str, InferenceEngine] = {}     # variant -> engine
        self.cold_store: Dict[str, Variant] = {}          # on "disk"
        self._alive = threading.Event()
        self._alive.set()
        self._threads = []
        self._lock = threading.Lock()
        self._work = queue.Queue()

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
            fn()

    # -- model management (Triton Load/Unload analogue) -----------------------
    def stage_cold(self, app: Application, variant: Variant):
        """Cold replica: weights on disk/host only."""
        self.cold_store[variant.name] = variant

    def load(self, app: Application, variant: Variant,
             warm: bool = True) -> float:
        """Draw params on the device + warm the engine; returns wall-clock
        load seconds."""
        if not self.alive:
            raise RuntimeError(f"{self.id} is down")
        t0 = time.monotonic()
        cfg = variant.config
        if cfg is None:
            raise ValueError(f"variant {variant.name} has no model config")
        gen = generator_for(self.device, variant_seed(variant.name))
        with torch.inference_mode():
            params = MDL.init_params(gen, cfg, device=self.device)
        eng = InferenceEngine(cfg, params, batch_slots=self.batch_slots,
                              max_len=self.max_len, device=self.device)
        if warm:
            eng.warmup()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            if not self.alive:
                raise RuntimeError(f"{self.id} died during load")
            self.engines[variant.name] = eng
        return time.monotonic() - t0

    def install(self, variant_name: str, engine: InferenceEngine):
        """Adopt a pre-built engine."""
        if not self.alive:
            raise RuntimeError(f"{self.id} is down")
        with self._lock:
            if not self.alive:
                raise RuntimeError(f"{self.id} died during install")
            self.engines[variant_name] = engine

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
            return False
        self._work.put(lambda: self._drain(eng))
        return True

    def _drain(self, eng: InferenceEngine):
        while eng.active_count() and self._alive.is_set():
            eng.step()
