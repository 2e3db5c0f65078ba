"""Cluster model: servers, sites (failure domains), instances, resources.

Maps the paper's edge testbed onto TPU serving cells (DESIGN.md §2): a
"server" is a serving cell with an HBM budget and compute budget; a
"site" is a correlated failure domain (pod / rack).  Resource vectors
follow the paper: r ∈ {mem, compute}.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

RESOURCES = ("mem", "compute")


@dataclass
class Instance:
    """A deployed model variant on a server."""
    app_id: str
    variant: "object"            # core.variants.Variant
    server_id: str
    role: str                    # "primary" | "warm" | "cold" | "loading"
    ready: bool = True

    @property
    def demand(self) -> Dict[str, float]:
        return self.variant.demand


@dataclass
class Server:
    id: str
    site: str
    capacity: Dict[str, float]
    alive: bool = True
    instances: Dict[str, Instance] = field(default_factory=dict)

    def used(self, r: str) -> float:
        # cold instances live on disk/host, not in the accelerator budget
        return sum(inst.demand[r] for inst in self.instances.values()
                   if inst.role != "cold")

    def free(self, r: str) -> float:
        return self.capacity[r] - self.used(r)

    def fits(self, demand: Dict[str, float]) -> bool:
        return all(self.free(r) >= demand[r] - 1e-9 for r in RESOURCES)

    def headroom(self) -> float:
        """Normalized min free fraction across resources (worst-fit key)."""
        return min(self.free(r) / self.capacity[r] for r in RESOURCES)


class Cluster:
    """Servers grouped into sites; tracks placement + liveness.

    `storage` is the cluster's storage topology (per-server disk+NIC
    bandwidth, shared cloud uplink, checkpoint replication policy — a
    `core.modelstate.StorageConfig`); None means the default
    local-everything topology, under which model loading reduces to the
    historical flat ``bytes / LOAD_BW + warmup`` cost.
    """

    def __init__(self, servers: List[Server], storage=None):
        self.storage = storage
        self.servers: Dict[str, Server] = {s.id: s for s in servers}
        self.sites: Dict[str, List[str]] = {}
        for s in servers:
            self.sites.setdefault(s.site, []).append(s.id)
        self._counter = itertools.count()
        # change observers, fired with the touched server id on every
        # capacity-relevant mutation (place/remove/fail/revive) — the
        # planner's array state subscribes here for incremental sync
        self._observers: List = []

    # -- change notification -------------------------------------------------
    def subscribe(self, fn) -> None:
        """Register `fn(server_id)` to run after every mutation of that
        server's instances or liveness."""
        self._observers.append(fn)

    def unsubscribe(self, fn) -> None:
        if fn in self._observers:
            self._observers.remove(fn)

    def _notify(self, server_id: str) -> None:
        for fn in tuple(self._observers):
            fn(server_id)

    # -- queries ------------------------------------------------------------
    def alive_servers(self) -> List[Server]:
        return [s for s in self.servers.values() if s.alive]

    def server_of_site(self, site: str) -> List[Server]:
        return [self.servers[sid] for sid in self.sites.get(site, ())]

    def instances_of(self, app_id: str, role: Optional[str] = None):
        out = []
        for s in self.servers.values():
            for key, inst in s.instances.items():
                if inst.app_id == app_id and (role is None
                                              or inst.role == role):
                    out.append((key, inst))
        return out

    def total_free(self, alive_only=True) -> Dict[str, float]:
        servers = self.alive_servers() if alive_only else list(
            self.servers.values())
        return {r: sum(s.free(r) for s in servers) for r in RESOURCES}

    def total_capacity(self) -> Dict[str, float]:
        return {r: sum(s.capacity[r] for s in self.alive_servers())
                for r in RESOURCES}

    # -- placement ----------------------------------------------------------
    def place(self, app_id: str, variant, server_id: str, role: str,
              ready: bool = True) -> str:
        srv = self.servers[server_id]
        inst = Instance(app_id, variant, server_id, role, ready)
        if role != "cold" and not srv.fits(inst.demand):
            raise ValueError(
                f"{server_id} cannot fit {app_id}/{variant.name}: "
                f"free={ {r: round(srv.free(r),1) for r in RESOURCES} } "
                f"demand={inst.demand}")
        key = f"{app_id}@{variant.name}#{next(self._counter)}"
        srv.instances[key] = inst
        self._notify(server_id)
        return key

    def remove(self, key: str, server_id: str):
        if self.servers[server_id].instances.pop(key, None) is not None:
            self._notify(server_id)

    def remove_app(self, app_id: str) -> List[str]:
        """Drop every instance of an app (departure); returns the keys."""
        removed = []
        for srv in self.servers.values():
            keys = [k for k, inst in srv.instances.items()
                    if inst.app_id == app_id]
            for key in keys:
                del srv.instances[key]
                removed.append(key)
            if keys:
                self._notify(srv.id)
        return removed

    # -- failures -----------------------------------------------------------
    def fail_server(self, server_id: str) -> List[Instance]:
        """Idempotent: a second fail of a dead server loses nothing new."""
        srv = self.servers[server_id]
        if not srv.alive:
            return []
        srv.alive = False
        self._notify(server_id)
        return list(srv.instances.values())

    def fail_site(self, site: str) -> List[Instance]:
        lost = []
        for sid in self.sites.get(site, ()):
            lost.extend(self.fail_server(sid))
        return lost

    def revive_server(self, server_id: str) -> Server:
        """A rejoining node comes back alive and EMPTY (its accelerator
        state did not survive the crash); the control plane re-fills it."""
        srv = self.servers[server_id]
        srv.instances.clear()
        srv.alive = True
        self._notify(server_id)
        return srv

    # backwards-compatible alias
    def recover_server(self, server_id: str):
        self.revive_server(server_id)


def make_cluster(n_sites: int, servers_per_site: int,
                 mem: float = 16e9, compute: float = 1.0) -> Cluster:
    """Uniform cluster: paper testbed = 3 sites x 2; sim = 10 x 10."""
    servers = []
    for si in range(n_sites):
        for sj in range(servers_per_site):
            servers.append(Server(
                id=f"s{si}-{sj}", site=f"site{si}",
                capacity={"mem": mem, "compute": compute}))
    return Cluster(servers)
