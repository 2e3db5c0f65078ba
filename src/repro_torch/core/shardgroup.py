"""Shard-aware failure plane: tensor-parallel deployments as
first-class failure-domain objects.

FailLite's failure model (and this repo's reproduction of it through
PR 8) treats a model instance as atomic: a server dies, the whole
replica dies, recovery means loading a (smaller) variant elsewhere.
Modern LLM serving is tensor-parallel: one deployment spans k servers,
each holding 1/k of the weights, and one host failing kills only a
*shard* of a live group. This module makes that first-class:

* **`ShardGroup`** — one app deployed TP-k across k distinct servers
  (co-site preferred, `PlannerState.place_group`). Each member holds a
  *slice variant* (`<full>::shard<r>of<k>`: 1/k of the bytes and
  FLOPs) whose checkpoint slice has its own residency and fetch path
  in the model-state plane, so a reshard refetch is priced as slice
  bytes — not the whole monolith.
* **`ShardGroupManager`** — the controller-side plane. On a member
  loss (a `ShardFail` or any crash of a member host) it walks a
  recovery ladder chosen per-app by criticality:

    (a) degraded-TP continuation (KevlarFlow-style): the surviving
        k-1 shards keep serving immediately at reduced throughput and
        slightly reduced accuracy — a synthetic degraded variant
        (`<full>::tp<k-1>of<k>`) is synthesized from the group and
        routed without any blackout for the clients;
    (b) reshard onto survivors (FailSafe-style): a replacement server
        refetches the lost slice through the RecoveryScheduler and
        the contention-aware load engine, then pays an explicit
        *repartition* phase (survivors re-shuffle their partitions),
        restoring full TP-k;
    (c) monolith fallback: the group dissolves and the app takes
        today's progressive-failover path (smallest variant first).

  Every action lands in the controller's normal `RecoveryRecord`
  stream (modes ``shard-degrade`` / ``shard-reshard``; fallback keeps
  the cold/cold-progressive modes) with the standard MTTR phase
  decomposition plus a new ``repartition`` phase.

The plane is strictly additive: with ``tp_degree=1`` (the default) no
manager is constructed, no code path below runs, and every pinned
golden fingerprint is bit-exact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.controller import NOTIFY_OVERHEAD_S, RecoveryRecord
from repro_torch.core.variants import Application, LOAD_BW, Variant

SHARD_POLICIES = ("auto", "degrade", "reshard", "monolith")

# degraded-TP continuation: re-planning the parallelism over the
# survivors (no bytes move — KevlarFlow skips the lost partition)
DEGRADE_REPARTITION_S = 0.025
# accuracy discount per lost-shard fraction: serving with k-1 of k
# partitions drops quality a little, far less than a smaller monolith
DEGRADE_ACC_PENALTY = 0.04
# reshard repartition: survivors re-shuffle ~this fraction of the
# replaced slice's bytes through the disk path (all-gather style),
# plus a fixed re-plan cost
RESHARD_REPARTITION_FRAC = 0.5
REPARTITION_BASE_S = 0.010


def slice_name(variant: Variant, rank: int, k: int) -> str:
    return f"{variant.name}::shard{rank}of{k}"


def degraded_name(variant: Variant, k_alive: int, k: int) -> str:
    return f"{variant.name}::tp{k_alive}of{k}"


@dataclass
class Member:
    """One shard-group member: a slice instance on one server."""
    rank: int
    server_id: str
    key: str                      # cluster instance key


@dataclass
class ShardGroup:
    """One TP-k deployment. `state` is the group lifecycle:

        live        exactly k members, serving the full variant
        degraded    k-1 members continue serving (synthetic variant)
        resharding  k-1 members + one replacement slice in flight
        fallen-back dissolved; the app is an ordinary monolith again
    """
    app_id: str
    tp_degree: int
    base: Variant                          # the full variant sharded
    policy: str                            # degrade|reshard|monolith
    members: Dict[int, Member] = field(default_factory=dict)
    state: str = "live"
    pending: Optional[Member] = None       # reshard target in flight

    @property
    def lead(self) -> Member:
        return self.members[min(self.members)]


class ShardGroupManager:
    """Controller-side shard plane (see module docstring).

    `defer(dt, fn)` schedules work `dt` sim-seconds ahead (the
    simulator wires its event queue; the testbed wires a timer); when
    None, deferred work applies immediately and only the recorded MTTR
    carries the repartition time.
    """

    def __init__(self, controller, *, tp_degree: int,
                 policy: str = "auto",
                 defer: Optional[Callable[[float, Callable], None]] = None):
        assert tp_degree >= 2, tp_degree
        assert policy in SHARD_POLICIES, policy
        self.controller = controller
        self.tp_degree = tp_degree
        self.policy = policy
        self.defer = defer
        self.groups: Dict[str, ShardGroup] = {}
        # synthesized (degraded) variants by name: these are routing
        # objects only — never appended to app.variants, which would
        # corrupt `app.smallest` and the cached demand matrices
        self._synth: Dict[str, Variant] = {}
        # (action, RecoveryRecord) pairs; records fill in async, so
        # summary() reads them lazily at end of run
        self._log: List[tuple] = []
        # reshard repartition calibration (testbed-measured scale on
        # the modeled byte-shuffle cost)
        self.repartition_scale = 1.0
        controller.attach_shard_manager(self)

    # -- variant synthesis ---------------------------------------------------
    def slice_variant(self, base: Variant, rank: int) -> Variant:
        k = self.tp_degree
        return Variant(name=slice_name(base, rank, k), family=base.family,
                       mem_bytes=base.mem_bytes / k,
                       compute=base.compute / k,
                       accuracy=base.accuracy,
                       quant_bits=base.quant_bits)

    def degraded_variant(self, base: Variant, k_alive: int) -> Variant:
        """KevlarFlow-style continuation variant: the surviving k_alive
        of k partitions serve with proportionally less parallelism
        (service time scales k/k_alive) and a small accuracy discount
        for the skipped partition."""
        k = self.tp_degree
        name = degraded_name(base, k_alive, k)
        v = self._synth.get(name)
        if v is None:
            lost_frac = (k - k_alive) / k
            v = Variant(name=name, family=base.family,
                        mem_bytes=base.mem_bytes * k_alive / k,
                        compute=base.compute * k / k_alive,
                        accuracy=base.accuracy
                        * (1.0 - DEGRADE_ACC_PENALTY * lost_frac),
                        quant_bits=base.quant_bits)
            self._synth[name] = v
        return v

    def lookup_variant(self, name: str) -> Optional[Variant]:
        """Side-table lookup for synthesized variant names (the traffic
        plane's route observer falls back to this when
        `app.variant_by_name` misses)."""
        return self._synth.get(name)

    # -- queries -------------------------------------------------------------
    def is_grouped(self, app_id: str) -> bool:
        """True while the app is shard-protected (a fallen-back group
        is an ordinary monolith again and re-enters warm planning)."""
        g = self.groups.get(app_id)
        return g is not None and g.state != "fallen-back"

    def _resolve_policy(self, app: Application) -> str:
        if self.policy != "auto":
            return self.policy
        # criticality ladder: critical apps must not go dark -> degrade
        # and keep serving; the rest restore full quality via reshard
        return "degrade" if app.critical else "reshard"

    def _can_degrade(self, g: ShardGroup, lost_ranks: List[int],
                     pending_dead: bool) -> bool:
        """Single member lost from a live degrade-policy group: the
        survivors continue (KevlarFlow tolerates one missing
        partition; a second loss falls through to monolith)."""
        return (g.state == "live" and g.policy == "degrade"
                and len(lost_ranks) == 1 and not pending_dead
                and len(g.members) - 1 >= 1)

    def _seamless(self, g: ShardGroup, lost_ranks: List[int],
                  pending_dead: bool) -> bool:
        """Does this loss continue serving with zero client blackout?
        Degraded continuation of a NON-lead member: the routed lead
        survives and keeps answering. A lead loss still degrades, but
        clients see the gap until the route flips to a survivor. Must
        be decidable at crash time — `darkened_by` and `handle_lost`
        agree through this."""
        return (self._can_degrade(g, lost_ranks, pending_dead)
                and min(g.members) not in lost_ranks)

    def darkened_by(self, failed_set: Set[str]) -> Set[str]:
        """App ids that go dark for clients when `failed_set` crashes:
        every affected group EXCEPT a seamless degrade of a non-lead
        member (survivors keep answering on the routed lead). The
        simulator calls this at the crash instant to open downtime
        windows for shard losses whose route still points at a live
        lead."""
        out: Set[str] = set()
        for gid, g in self.groups.items():
            if g.state == "fallen-back":
                continue
            lost = [r for r, m in g.members.items()
                    if m.server_id in failed_set]
            pending_dead = (g.pending is not None
                            and g.pending.server_id in failed_set)
            if not lost and not pending_dead:
                continue
            if not self._seamless(g, lost, pending_dead):
                out.add(gid)
        return out

    # -- deployment ----------------------------------------------------------
    def deploy_group(self, app: Application) -> List[str]:
        """Deploy `app` as a TP-k group: k distinct servers (co-site
        preferred), one slice instance each, slice checkpoints staged,
        route on the rank-0 lead. Raises ValueError when no k-server
        placement exists (mirrors `deploy_primary`)."""
        ctl = self.controller
        k = self.tp_degree
        probe = self.slice_variant(app.full, 0)
        sids = ctl.state.place_group(probe.demand_vec, k)
        if sids is None:
            raise ValueError(f"no {k}-server placement for group "
                             f"of {app.id}")
        members: Dict[int, Member] = {}
        for rank, sid in enumerate(sids):
            sv = self.slice_variant(app.full, rank)
            key = ctl.cluster.place(app.id, sv, sid, "shard")
            members[rank] = Member(rank, sid, key)
            if ctl.registry is not None:
                ctl.registry.stage(sv.name, sid)
        # register only after every slice placed (mirror deploy_primary)
        ctl.apps[app.id] = app
        ctl._reg_seq[app.id] = next(ctl._reg_counter)
        ctl.primaries[app.id] = sids[0]
        ctl.routing.set(app.id, sids[0], app.full.name)
        ctl.ds.put(f"primary/{app.id}",
                   {"server": sids[0], "variant": app.full.name,
                    "tp_degree": k, "members": list(sids)})
        self.groups[app.id] = ShardGroup(
            app_id=app.id, tp_degree=k, base=app.full,
            policy=self._resolve_policy(app), members=members)
        return sids

    def forget(self, app_id: str):
        """App departed: drop its group (instances are released by
        `cluster.remove_app`)."""
        self.groups.pop(app_id, None)

    # -- failure handling ----------------------------------------------------
    def handle_lost(self, failed_set: Set[str], t_fail: float,
                    t_detect: float) -> Dict[str, RecoveryRecord]:
        """Walk every group hit by this epoch's crashed servers through
        the recovery ladder. Called by `handle_failures` before the
        warm/cold split; returns the grouped apps' records."""
        ctl = self.controller
        records: Dict[str, RecoveryRecord] = {}
        for gid, g in self.groups.items():
            if g.state == "fallen-back":
                continue
            lost_ranks = [r for r, m in g.members.items()
                          if m.server_id in failed_set]
            pending_dead = (g.pending is not None
                            and g.pending.server_id in failed_set)
            if not lost_ranks and not pending_dead:
                continue
            app = ctl.apps.get(gid)
            if app is None:
                continue
            can_degrade = self._can_degrade(g, lost_ranks, pending_dead)
            ctl._bump(gid)                 # void stale load callbacks
            ctl._unrecovered.pop(gid, None)
            for r in lost_ranks:
                del g.members[r]
            if pending_dead:
                g.pending = None
            can_reshard = (g.state == "live" and g.policy == "reshard"
                           and len(lost_ranks) == 1 and not pending_dead
                           and len(g.members) >= 1)
            if can_degrade:
                records[gid] = self._degrade(g, app, t_fail, t_detect)
            elif can_reshard:
                records[gid] = self._reshard(g, app, lost_ranks[0],
                                             failed_set, t_fail, t_detect)
            else:
                records[gid] = self._fallback(g, app, t_fail, t_detect)
        return records

    # -- ladder rung (a): degraded-TP continuation ---------------------------
    def _degrade(self, g: ShardGroup, app: Application, t_fail: float,
                 t_detect: float) -> RecoveryRecord:
        ctl = self.controller
        dv = self.degraded_variant(g.base, len(g.members))
        lead = g.lead
        ctl.primaries[app.id] = lead.server_id
        ctl.routing.set(app.id, lead.server_id, dv.name)
        ctl.ds.put(f"primary/{app.id}",
                   {"server": lead.server_id, "variant": dv.name,
                    "tp_degree": g.tp_degree,
                    "members": [m.server_id
                                for m in g.members.values()]})
        g.state = "degraded"
        mttr = ((t_detect - t_fail) + DEGRADE_REPARTITION_S
                + NOTIFY_OVERHEAD_S)
        rec = RecoveryRecord(app.id, True, mttr, dv.name, dv.accuracy,
                             "shard-degrade")
        rec.phases = {"detect": t_detect - t_fail,
                      "repartition": DEGRADE_REPARTITION_S,
                      "route": NOTIFY_OVERHEAD_S}
        self._log.append(("shard-degrade", rec))
        return rec

    # -- ladder rung (b): reshard onto survivors -----------------------------
    def _disk_bw(self) -> float:
        reg = self.controller.registry
        return reg.storage.disk_bw if reg is not None else LOAD_BW

    def repartition_seconds(self, sv: Variant, k_alive: int) -> float:
        """Reshard repartition cost: survivors re-shuffle a fraction of
        the replaced slice's bytes (all-gather style) through the disk
        path, scaled by the testbed-calibrated factor."""
        del k_alive
        return (REPARTITION_BASE_S + self.repartition_scale
                * RESHARD_REPARTITION_FRAC * sv.mem_bytes
                / self._disk_bw())

    def calibrate_repartition(self, measured_s: float,
                              slice_bytes: float, ewma: float = 0.3):
        """Fold one testbed-measured repartition wall time into the
        modeled cost (EWMA on the scale factor, like LoadCostModel)."""
        modeled = (RESHARD_REPARTITION_FRAC * slice_bytes
                   / self._disk_bw())
        if modeled <= 0 or measured_s <= 0:
            return
        obs = max(measured_s - REPARTITION_BASE_S, 0.0) / modeled
        self.repartition_scale = ((1 - ewma) * self.repartition_scale
                                  + ewma * obs)

    def _after_repartition(self, g: ShardGroup, sv: Variant,
                           repart_s: float, finish: Callable[[], None]):
        """Apply the repartition phase then commit the reshard. The sim
        defers `finish` by the MODELED cost; the testbed subclass
        overrides this to do the real work (re-gather the slices and
        rebuild the serving engine) and commit when it actually
        finishes, feeding the measured wall time back into
        `calibrate_repartition`."""
        del g, sv
        if self.defer is not None and repart_s > 0:
            self.defer(repart_s, finish)
        else:
            finish()

    def _reshard(self, g: ShardGroup, app: Application, rank: int,
                 failed_set: Set[str], t_fail: float,
                 t_detect: float) -> RecoveryRecord:
        ctl = self.controller
        sv = self.slice_variant(g.base, rank)
        excl = ({m.server_id for m in g.members.values()}
                | set(failed_set))
        sid = ctl.state.worst_fit(sv.demand_vec, excluded=excl)
        if sid is None:
            return self._fallback(g, app, t_fail, t_detect)
        try:
            key = ctl.cluster.place(app.id, sv, sid, "loading",
                                    ready=False)
        except ValueError:
            return self._fallback(g, app, t_fail, t_detect)
        g.state = "resharding"
        g.pending = Member(rank, sid, key)
        rec = RecoveryRecord(app.id, False)
        gen = ctl._gen.get(app.id, 0)
        plan_s = ctl._last_plan_wall

        def _stale() -> bool:
            return (ctl._gen.get(app.id, 0) != gen
                    or app.id not in ctl.apps
                    or not ctl.cluster.servers[sid].alive
                    or g.pending is None or g.pending.key != key)

        def on_slice_ready(t_ready: float):
            if _stale():
                return
            repart = self.repartition_seconds(sv, len(g.members))

            def finish():
                if _stale():
                    return
                inst = ctl.cluster.servers[sid].instances.get(key)
                if inst is not None:
                    inst.role = "shard"
                    inst.ready = True
                g.members[rank] = g.pending
                g.pending = None
                g.state = "live"
                lead = g.lead
                ctl.primaries[app.id] = lead.server_id
                ctl.routing.set(app.id, lead.server_id, g.base.name)
                rec.recovered = True
                rec.mttr = ((t_detect - t_fail) + (t_ready - t_detect)
                            + repart + NOTIFY_OVERHEAD_S)
                rec.variant = g.base.name
                rec.accuracy = g.base.accuracy
                rec.mode = "shard-reshard"
                rec.phases = {"detect": t_detect - t_fail,
                              "plan": plan_s,
                              "repartition": repart,
                              "route": NOTIFY_OVERHEAD_S}
                ticket = handle.ticket
                if ticket is not None:
                    rec.source = ticket.source
                    rec.phases.update(queue=ticket.queue_s,
                                      fetch=ticket.fetch_s,
                                      warmup=ticket.warmup_s)
                ctl.ds.put(f"primary/{app.id}",
                           {"server": lead.server_id,
                            "variant": g.base.name,
                            "tp_degree": g.tp_degree,
                            "members": [m.server_id
                                        for m in g.members.values()]})

            self._after_repartition(g, sv, repart, finish)

        handle = ctl.scheduler.submit(app, sv, sid, on_slice_ready)
        self._log.append(("shard-reshard", rec))
        return rec

    # -- ladder rung (c): monolith fallback ----------------------------------
    def _fallback(self, g: ShardGroup, app: Application, t_fail: float,
                  t_detect: float) -> RecoveryRecord:
        """Dissolve the group and take today's progressive path. The
        app re-enters normal (warm-backup) protection from here on."""
        ctl = self.controller
        for m in list(g.members.values()):
            srv = ctl.cluster.servers.get(m.server_id)
            if (srv is not None and srv.alive
                    and m.key in srv.instances):
                ctl.cluster.remove(m.key, m.server_id)
        g.members.clear()
        if g.pending is not None:
            srv = ctl.cluster.servers.get(g.pending.server_id)
            if (srv is not None and srv.alive
                    and g.pending.key in srv.instances):
                ctl.cluster.remove(g.pending.key, g.pending.server_id)
            g.pending = None
        g.state = "fallen-back"
        # The dissolved group has no serving primary anymore (the lead's
        # gathered engine is gone); a stale entry would make the planner
        # anti-affinity exclude the surviving lead's server — fatal when
        # it is the only capacity left (mirrors handle_failures).
        ctl.primaries.pop(app.id, None)
        if ctl._is_warm_candidate(app):
            ctl._warm_missing.add(app.id)
        recs = ctl._progressive([app], t_fail, t_detect)
        rec = recs[app.id]
        self._log.append(("shard-monolith", rec))
        return rec

    # -- invariants + reporting ----------------------------------------------
    def check_conservation(self):
        """Shard-group conservation invariant (the property test's
        oracle): every group is in exactly one lifecycle state and its
        member count matches that state."""
        k = self.tp_degree
        for gid, g in self.groups.items():
            assert g.state in ("live", "degraded", "resharding",
                               "fallen-back"), (gid, g.state)
            n = len(g.members)
            if g.state == "live":
                assert n == k and g.pending is None, (gid, n)
            elif g.state == "degraded":
                assert 1 <= n < k and g.pending is None, (gid, n)
            elif g.state == "resharding":
                assert 1 <= n < k and g.pending is not None, (gid, n)
            else:                                    # fallen-back
                assert n == 0 and g.pending is None, (gid, n)

    def summary(self) -> dict:
        states: Dict[str, int] = {}
        for g in self.groups.values():
            states[g.state] = states.get(g.state, 0) + 1
        actions: Dict[str, int] = {}
        mttrs: Dict[str, List[float]] = {}
        for action, rec in self._log:
            actions[action] = actions.get(action, 0) + 1
            if rec.recovered and math.isfinite(rec.mttr):
                mttrs.setdefault(action, []).append(rec.mttr)
        return {
            "tp_degree": self.tp_degree,
            "policy": self.policy,
            "n_groups": len(self.groups),
            "states": states,
            "actions": actions,
            "mttr_avg_s": {a: sum(v) / len(v)
                           for a, v in mttrs.items() if v},
            "repartition_scale": self.repartition_scale,
        }
