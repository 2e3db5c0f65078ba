"""Model-state plane: checkpoint residency, storage topology, and the
calibrated load-cost model shared by the simulator and the testbed.

The paper's MTTR story is dominated by model loading (Fig. 2b): a cold
replica must stream checkpoint bytes before it can serve. Where those
bytes live decides how expensive that stream is. This module makes the
byte-location a first-class object:

  * `StorageConfig` — the storage topology attached to a `Cluster`:
    per-server disk->HBM bandwidth, per-server NIC bandwidth, and ONE
    shared cloud-origin uplink for the whole cluster, plus the
    checkpoint replication policy. The default (`"local"` preset)
    reproduces the repo's historical flat model exactly: every
    checkpoint is on every disk and every load costs
    ``bytes / disk_bw + warmup`` — bit-identical to the old
    ``Variant.load_time`` path.
  * `ModelRegistry` — tracks, per variant, WHICH servers hold the
    checkpoint on local disk (the cloud origin always has a copy), and
    selects the fetch path for a load: local disk hit ≫ peer server
    (same site preferred) ≫ cloud origin. Residency survives crashes
    (disk outlives the process, as on the testbed, where `stage_cold`
    content survives a worker kill) and can be persisted through the
    controller `DataStore` for controller-failover restores.
  * `LoadCostModel` — the Fig. 2b cost ``bytes / effective_bw(source)
    + warmup``, with per-source effective bandwidths that the testbed
    CALIBRATES from real measured load wall-times (`observe`). The
    simulator prices loads through the same class, so feeding a
    testbed calibration into a sim spec reproduces measured costs.

The per-link *queueing* (N concurrent cold loads on one uplink each
slow down) lives in the execution engines — `core/simulation.py`'s
`SimLoadExecutor` keys FIFO queues by the link names produced here.

Link naming convention (shared with the load engines and the
`LinkDegrade` scenario event):

    disk:<server_id>    the server's disk/PCIe->HBM channel
    nic:<server_id>     the server's NIC
    cloud               the shared cloud-origin uplink
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core.variants import LOAD_BW, WARMUP_S, Variant

# fetch-path sources, fastest to slowest
LOCAL, PEER, CLOUD = "local", "peer", "cloud"


def disk_link(server_id: str) -> str:
    return f"disk:{server_id}"


def nic_link(server_id: str) -> str:
    return f"nic:{server_id}"


CLOUD_LINK = "cloud"


@dataclass(frozen=True)
class StorageConfig:
    """Storage topology + replication policy of one cluster.

    ``replicate_all=True`` is the historical flat model: every variant
    checkpoint resident on every server's disk, so every load is a
    local hit at ``disk_bw`` — with the default bandwidths this reduces
    bit-exactly to the pre-model-state behavior. ``replicate_all=False``
    is the paper-faithful edge story: checkpoints live on ``replication``
    servers (primary's site excluded for the extras when possible) and
    everyone else fetches from a peer NIC or the shared cloud uplink.
    """
    disk_bw: float = LOAD_BW          # bytes/s, per-server disk->HBM
    nic_bw: float = math.inf          # bytes/s, per-server NIC
    cloud_bw: float = math.inf        # bytes/s, SHARED cloud-origin uplink
    warmup_s: float = WARMUP_S        # per-instance compile/alloc warmup
    replicate_all: bool = True        # every checkpoint on every disk
    replication: int = 2              # residency target otherwise
    name: str = "local"

    def with_(self, **kw) -> "StorageConfig":
        return replace(self, **kw)


#: Named presets, surfaced through `SimConfig.storage` /
#: `ExperimentSpec.storage`. "local" is the default (exact historical
#: behavior). "edge" is the paper-faithful constrained topology:
#: 10 GbE peer NICs, a 5 Gb/s shared cloud uplink (half a 10 Gb WAN
#: pipe, as edge sites typically see), checkpoints on 2 servers.
STORAGE_PRESETS: Dict[str, StorageConfig] = {
    "local": StorageConfig(name="local"),
    "edge": StorageConfig(nic_bw=1.25e9, cloud_bw=0.625e9,
                          replicate_all=False, replication=2,
                          name="edge"),
}


def storage_preset(name: str, **overrides) -> StorageConfig:
    """Look up a preset by name, applying non-None overrides."""
    try:
        cfg = STORAGE_PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown storage preset {name!r}; "
                       f"have {sorted(STORAGE_PRESETS)}") from None
    kw = {k: v for k, v in overrides.items() if v is not None}
    return cfg.with_(**kw) if kw else cfg


@dataclass(frozen=True)
class FetchPlan:
    """How one checkpoint reaches one server: the source class, the
    links the transfer serializes on, and the bottleneck bandwidth."""
    source: str                        # LOCAL | PEER | CLOUD
    links: Tuple[str, ...]
    bw: float
    src_server: Optional[str] = None   # peer fetches only


class LinkScale:
    """Multiplicative per-link bandwidth-scale windows — the shared
    `LinkDegrade` bookkeeping of both execution engines. `degrade`
    applies a factor and returns the matching restore callable; the
    caller schedules the restore on its own clock (event queue on the
    simulator, a timer thread on the testbed). Overlapping windows
    compose multiplicatively."""

    def __init__(self):
        self._scale: Dict[str, float] = {}

    def get(self, link: str) -> float:
        return self._scale.get(link, 1.0)

    def min_over(self, links: Iterable[str]) -> float:
        return min((self.get(l) for l in links), default=1.0)

    def degrade(self, link: str, factor: float):
        self._scale[link] = self.get(link) * factor

        def restore():
            s = self.get(link) / factor
            if abs(s - 1.0) < 1e-12:
                self._scale.pop(link, None)
            else:
                self._scale[link] = s

        return restore


@dataclass
class LoadTicket:
    """Per-load receipt an execution engine fills in: where the bytes
    came from and how the wall time decomposed. The controller folds
    this into `RecoveryRecord.phases` for the MTTR breakdown."""
    source: str = LOCAL
    queue_s: float = 0.0               # waited behind earlier transfers
    fetch_s: float = 0.0               # byte-transfer time
    warmup_s: float = 0.0              # compile/alloc warmup
    done: bool = False


class LoadCostModel:
    """Fig. 2b load-cost model with per-source calibration.

    ``seconds(variant, source, bw)`` prices a load as
    ``bytes / effective_bw + warmup``; the effective bandwidth is the
    topology's bottleneck unless a calibration observation exists for
    that source class. The testbed `observe()`s every real load it
    executes (measured wall seconds), maintaining an EWMA effective
    bandwidth per source — `to_dict()` of that calibration can be fed
    into a simulator run so both backends price loads identically.
    """

    def __init__(self, storage: StorageConfig,
                 calibration: Optional[Dict[str, float]] = None):
        self.storage = storage
        self._eff_bw: Dict[str, float] = dict(calibration or {})
        self.n_obs = 0
        # the testbed observes from worker threads while the
        # controller thread prices loads
        self._lock = threading.Lock()

    def effective_bw(self, source: str, topo_bw: float) -> float:
        with self._lock:
            return self._eff_bw.get(source, topo_bw)

    def seconds(self, variant: Variant, source: str, topo_bw: float,
                ) -> float:
        bw = self.effective_bw(source, topo_bw)
        return variant.mem_bytes / bw + self.storage.warmup_s

    def observe(self, variant: Variant, source: str, measured_s: float,
                *, ewma: float = 0.3) -> float:
        """Fold one measured load wall-time into the calibration;
        returns the updated effective bandwidth for `source`."""
        transfer = max(measured_s - self.storage.warmup_s, 1e-6)
        bw = variant.mem_bytes / transfer
        with self._lock:
            prev = self._eff_bw.get(source)
            self._eff_bw[source] = (bw if prev is None
                                    else (1.0 - ewma) * prev + ewma * bw)
            self.n_obs += 1
            return self._eff_bw[source]

    def to_dict(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._eff_bw)


class ModelRegistry:
    """Where every variant's checkpoint bytes are resident, per server.

    Replaces the old implicit assumption ("weights are wherever a load
    needs them") with explicit residency sets + fetch-path selection.
    A `version` counter bumps on every residency change so array views
    (`PlannerState`) can cache per-server residency masks.
    """

    def __init__(self, cluster, storage: Optional[StorageConfig] = None,
                 datastore=None):
        self.cluster = cluster
        self.storage = storage or getattr(cluster, "storage", None) \
            or STORAGE_PRESETS["local"]
        self.ds = datastore                      # optional durability
        self.calibration = LoadCostModel(self.storage)
        self._resident: Dict[str, Set[str]] = {}   # variant -> server ids
        self._seed_i = 0                           # deterministic spreading
        self.version = 0
        # the testbed stages/observes from worker threads while the
        # controller thread reads fetch plans
        self._lock = threading.RLock()

    # -- residency ----------------------------------------------------------
    def stage(self, variant_name: str, server_id: str) -> None:
        """Checkpoint bytes land on `server_id`'s disk."""
        if self.storage.replicate_all:
            return                               # trivially everywhere
        with self._lock:
            servers = self._resident.setdefault(variant_name, set())
            if server_id not in servers:
                servers.add(server_id)
                self.version += 1
                if self.ds is not None:
                    self.ds.put(f"ckpt/{variant_name}",
                                {"servers": sorted(servers)})

    def evict(self, variant_name: str, server_id: str) -> None:
        with self._lock:
            servers = self._resident.get(variant_name)
            if servers and server_id in servers:
                servers.discard(server_id)
                self.version += 1
                if self.ds is not None:
                    self.ds.put(f"ckpt/{variant_name}",
                                {"servers": sorted(servers)})

    def forget_app(self, app, in_use: Iterable[str] = ()) -> None:
        """App departed: garbage-collect its checkpoints — EXCEPT
        variants named in `in_use` (arch-mix apps of one architecture
        share variant names, so a surviving sibling keeps the bytes)."""
        keep = set(in_use)
        with self._lock:
            for v in app.variants:
                if v.name in keep:
                    continue
                if self._resident.pop(v.name, None) is not None:
                    self.version += 1
                    if self.ds is not None:
                        self.ds.delete(f"ckpt/{v.name}")

    def is_local(self, variant_name: str, server_id: str) -> bool:
        if self.storage.replicate_all:
            return True
        with self._lock:
            return server_id in self._resident.get(variant_name, ())

    def resident_servers(self, variant_name: str) -> Set[str]:
        if self.storage.replicate_all:
            return set(self.cluster.servers)
        with self._lock:
            return set(self._resident.get(variant_name, ()))

    def alive_resident(self, variant_name: str) -> List[str]:
        """Alive servers holding the checkpoint, sorted for determinism."""
        return sorted(sid for sid in self.resident_servers(variant_name)
                      if self.cluster.servers[sid].alive)

    def ensure_app(self, app, primary_sid: str) -> None:
        """Seed an arriving app's checkpoint replicas: the whole ladder
        on the primary's disk, plus ``replication - 1`` extra servers
        spread deterministically across OTHER sites (site-independent
        replicas, §3.4) so a site outage never strands every copy."""
        if self.storage.replicate_all:
            return
        extras = self._pick_replica_targets(primary_sid,
                                            self.storage.replication - 1)
        for v in app.variants:
            self.stage(v.name, primary_sid)
            for sid in extras:
                self.stage(v.name, sid)

    def _pick_replica_targets(self, primary_sid: str, n: int) -> List[str]:
        """`n` deterministic targets, rotating through the server list
        (so replicas spread), preferring sites != the primary's."""
        if n <= 0:
            return []
        ids = sorted(self.cluster.servers)
        p_site = self.cluster.servers[primary_sid].site
        off = self._seed_i
        self._seed_i += 1
        ranked = sorted(
            (sid for sid in ids if sid != primary_sid),
            key=lambda sid: (self.cluster.servers[sid].site == p_site,
                             (ids.index(sid) - off) % len(ids)))
        return ranked[:n]

    # -- fetch-path selection ----------------------------------------------
    def fetch_plan(self, variant_name: str, server_id: str) -> FetchPlan:
        """local disk hit ≫ peer server (same site first) ≫ cloud."""
        st = self.storage
        if self.is_local(variant_name, server_id):
            return FetchPlan(LOCAL, (disk_link(server_id),), st.disk_bw)
        peers = self.alive_resident(variant_name)
        peers = [p for p in peers if p != server_id]
        if peers:
            my_site = self.cluster.servers[server_id].site
            same = [p for p in peers
                    if self.cluster.servers[p].site == my_site]
            src = (same or peers)[0]
            return FetchPlan(PEER, (nic_link(src), nic_link(server_id)),
                             st.nic_bw, src_server=src)
        return FetchPlan(CLOUD, (CLOUD_LINK, nic_link(server_id)),
                         min(st.cloud_bw, st.nic_bw))

    def fetch_seconds(self, variant: Variant, server_id: str) -> float:
        """Uncontended fetch-time estimate (no queueing) — the planner's
        locality signal."""
        plan = self.fetch_plan(variant.name, server_id)
        bw = self.calibration.effective_bw(plan.source, plan.bw)
        if not math.isfinite(bw) or bw <= 0:
            return 0.0
        return variant.mem_bytes / bw

    def load_seconds(self, variant: Variant, server_id: str) -> float:
        """Uncontended end-to-end load estimate (fetch + warmup)."""
        plan = self.fetch_plan(variant.name, server_id)
        return self.calibration.seconds(variant, plan.source, plan.bw)

    # -- protection view ----------------------------------------------------
    def under_replicated(self, apps: Iterable, *,
                         variant_of=lambda a: a.smallest) -> List[tuple]:
        """(app, variant, n_alive_copies) for apps whose failover entry
        variant has fewer alive disk copies than the replication target.
        Empty under ``replicate_all`` (trivially everywhere)."""
        if self.storage.replicate_all:
            return []
        out = []
        for app in apps:
            v = variant_of(app)
            n = len(self.alive_resident(v.name))
            if n < self.storage.replication:
                out.append((app, v, n))
        return out

    def replication_target(self, variant_name: str) -> Optional[str]:
        """Best alive server to receive a new copy: most free memory,
        deterministic first-max — None if every alive server holds it."""
        have = self.resident_servers(variant_name)
        best, best_free = None, -1.0
        for sid in sorted(self.cluster.servers):
            srv = self.cluster.servers[sid]
            if not srv.alive or sid in have:
                continue
            f = srv.free("mem")
            if f > best_free:
                best, best_free = sid, f
        return best
