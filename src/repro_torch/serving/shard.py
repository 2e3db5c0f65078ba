"""Testbed shard plane (port of ``repro/serving/shard.py``): REAL
tensor-parallel groups on worker threads.

`core/shardgroup.py` gives the control plane (group lifecycle, the
degrade/reshard/monolith ladder, recovery records); this module is the
mini-testbed's data plane for it. Nothing here is modeled:

* at deploy, the app's full param tree is drawn once on the lead's
  device and **partitioned along the `parallel/sharding.py` "model"
  axes** (heads / d_ff / experts / vocab — the production TP rules) into
  `tp_degree` rank slices, each hosted in a different `WorkerServer`'s
  slice store on that device (`host_shard`; a `kill()` loses the slice,
  the cold store does not have it);
* the serving engine is assembled by gathering the slices off the member
  workers (`torch.cat` per model axis — the all-gather) and warmed on the
  rank-0 lead;
* a shard-host kill breaks the group: the ladder's real costs are paid
  on the wall clock — degraded-TP continuation rebuilds an engine from
  the surviving slices with the lost partition zero-filled (KevlarFlow:
  fewer effective heads/channels, measurably degraded output), and a
  reshard re-materializes the lost slice from the deterministic
  checkpoint seed, pays the slice-byte fetch through the model-state
  plane, then re-gathers and rebuilds;
* every measured wall time is folded back into the sim's reshard cost
  model through `ShardGroupManager.calibrate_repartition`, and the raw
  measurements ride out through ``extras["shard"]["measured"]``.

Departure from the JAX module (ROADMAP P12): nothing here catches an
exception. Background work runs through `TestbedExecutor._spawn`, which
drops only `WorkerDown` (a member died under the work) and reports every
other exception — a kernel that fails to build or launch, an
out-of-memory error — in the testbed's ``load_errors``; the JAX module
drops every RuntimeError of a rebuild, a repartition or an arrival's
build.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.core.shardgroup import (ShardGroup, ShardGroupManager,
                                         slice_name)
from repro_torch.core.variants import Application, Variant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import param_specs
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.server import draw_params

# ---------------------------------------------------------------------------
# param-tree partitioning along the production TP ("model") axes
# ---------------------------------------------------------------------------


def _walk2(a, b, fn):
    """Parallel structural walk: `b` mirrors `a`'s dict/list nesting
    (partition specs are tuples but sit at `a`'s leaf positions, so
    dispatch on `a` only)."""
    if isinstance(a, dict):
        return {k: _walk2(a[k], b[k], fn) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)([_walk2(x, y, fn) for x, y in zip(a, b)])
    return fn(a, b)


def _model_axis(spec, shape, k: int) -> Optional[int]:
    """The axis this leaf is TP-split on, or None (replicated)."""
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "model" in axes and i < len(shape) and shape[i] >= k:
            return i
    return None


def split_axes(params, k: int):
    """Tree of split-axis indices (None = replicated), derived from the
    same `param_specs` rules the production mesh uses."""
    specs = param_specs(params)
    return _walk2(params, specs,
                  lambda leaf, spec: _model_axis(spec, leaf.shape, k))


def rank_slice(params, axes, k: int, rank: int):
    """Rank `rank`'s slice of the full tree (what one worker's memory
    holds). A split leaf is cut with `torch.tensor_split` — the section
    sizes of `np.array_split` — and copied, so the slice owns its bytes
    and the full draw can be freed; a replicated leaf is the full tree's
    own tensor."""
    def cut(leaf, ax):
        if ax is None:
            return leaf
        return torch.tensor_split(leaf, k, dim=ax)[rank].clone(
            memory_format=torch.contiguous_format)
    return _walk2(params, axes, cut)


class _LeafMeta:
    """Shape, dtype and device of one slice leaf (a non-tuple leaf type,
    so the structural walkers don't recurse into it)."""
    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = device


def slice_meta(slice_tree, axes):
    """Shape/dtype tree of one rank slice — enough to zero-fill a lost
    partition for degraded-TP continuation."""
    return _walk2(slice_tree, axes,
                  lambda leaf, _ax: _LeafMeta(leaf.shape, leaf.dtype,
                                              leaf.device))


def zero_slice(meta):
    return _walk2(meta, meta,
                  lambda m, _: torch.zeros(m.shape, dtype=m.dtype,
                                           device=m.device))


def gather(rank_trees: List, axes):
    """All-gather: concatenate the k rank slices back into one param
    tree on the slices' own device; replicated leaves come from the
    first rank."""
    t0 = rank_trees[0]

    def walk(node0, ax_node, picks):
        if isinstance(node0, dict):
            return {key: walk(node0[key], ax_node[key],
                              [p[key] for p in picks]) for key in node0}
        if isinstance(node0, (list, tuple)):
            return type(node0)(
                [walk(v, ax_node[i], [p[i] for p in picks])
                 for i, v in enumerate(node0)])
        if ax_node is None:
            return node0
        return torch.cat(picks, dim=ax_node)
    return walk(t0, axes, rank_trees)


def checkpoint_params(variant: Variant, device: DeviceLike = None):
    """The deterministic 'checkpoint': identical to what
    `WorkerServer.load` draws for this variant on `device`, so a
    re-materialized slice is bit-identical to the lost one."""
    return draw_params(variant, resolve_device(device))


@dataclass
class _GroupLayout:
    """Per-group partition metadata kept OFF the workers (the slices
    themselves live on the workers and die with them)."""
    axes: object
    rank_meta: Dict[int, object] = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    """Wait for the device, so a wall time covers the work it timed."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the testbed manager: control plane + real data plane
# ---------------------------------------------------------------------------


class TestbedShardManager(ShardGroupManager):
    """`ShardGroupManager` whose repartition/degrade phases are real
    PyTorch work on the testbed's worker threads, wall-clock measured."""

    def __init__(self, testbed, *, tp_degree: int, policy: str = "auto"):
        super().__init__(testbed.controller, tp_degree=tp_degree,
                         policy=policy, defer=None)
        self.tb = testbed
        self._layout: Dict[str, _GroupLayout] = {}
        # routes consumed while their engine is still building:
        # app_id -> (server_id, variant_name), pushed on install
        self._deferred: Dict[str, tuple] = {}
        self._fail_ctx: Dict[str, float] = {}      # app_id -> t_fail
        self._meas_lock = threading.Lock()
        self.measured: Dict[str, List[float]] = {
            "deploy_build_s": [],       # initial gather+warmup per group
            "slice_fetch_s": [],        # reshard slice re-materialization
            "repartition_s": [],        # reshard re-gather + rebuild
            "reshard_mttr_s": [],       # kill -> resharded engine serving
            "degrade_rebuild_s": [],    # zero-filled degraded rebuild
            "degrade_mttr_s": [],       # kill -> degraded engine serving
        }

    def _note(self, key: str, value: float):
        with self._meas_lock:
            self.measured[key].append(value)

    # -- data-plane deploy --------------------------------------------------
    def is_slice(self, name: str) -> bool:
        return "::shard" in name

    def deploy_real(self, app: Application):
        """Partition the app's full params across the group members and
        bring up the gathered engine on the lead. Call after the
        controller-side `deploy_group`."""
        g = self.groups[app.id]
        k = g.tp_degree
        lead = self.tb.workers[g.lead.server_id]
        t0 = time.monotonic()
        params = checkpoint_params(g.base, lead.device)
        axes = split_axes(params, k)
        layout = _GroupLayout(axes=axes)
        slices = {}
        with torch.inference_mode():
            for rank, m in sorted(g.members.items()):
                sl = rank_slice(params, axes, k, rank)
                layout.rank_meta[rank] = slice_meta(sl, axes)
                self.tb.workers[m.server_id].host_shard(
                    slice_name(g.base, rank, k), sl)
                slices[rank] = sl
            del params                  # the engine comes from the slices
            self._layout[app.id] = layout
            gathered = gather([slices[r] for r in sorted(slices)], axes)
        del slices
        self._install(g, lead.id, g.base.name, gathered)
        self._note("deploy_build_s", time.monotonic() - t0)
        self._push_if_current(app.id)

    def _install(self, g: ShardGroup, server_id: str, name: str,
                 params) -> None:
        w = self.tb.workers[server_id]
        eng = InferenceEngine(g.base.config, params,
                              batch_slots=w.batch_slots,
                              max_len=w.max_len, device=w.device)
        eng.warmup()
        _sync(w.device)
        w.install(name, eng)

    # -- route interception -------------------------------------------------
    def on_route(self, app_id: str, server_id: str,
                 variant_name: str) -> bool:
        """RoutingTable-observer hook: push the route to the serving
        router only once the target engine is actually resident.
        Returns True when the push is deferred to an install."""
        g = self.groups.get(app_id)
        if g is None or g.state == "fallen-back":
            return False
        w = self.tb.workers.get(server_id)
        if w is None:
            return False
        if not w.has(variant_name) and "::tp" in variant_name:
            # degraded route: the lead's gathered engine (if it
            # survived) keeps answering under the degraded name until
            # the honest zero-filled rebuild swaps in underneath
            w.alias(variant_name, g.base.name)
        if w.has(variant_name):
            return False
        self._deferred[app_id] = (server_id, variant_name)
        return True

    def _push_if_current(self, app_id: str):
        """Flush a deferred route if it still matches the controller's
        current routing decision."""
        pending = self._deferred.pop(app_id, None)
        if pending is None:
            return
        with self.tb._ctl_lock:
            current = self.controller.routing.routes.get(app_id)
        if current is None or tuple(current) != tuple(pending):
            return
        self.tb._push_route(app_id, pending[0], pending[1])

    # -- ladder overrides: real work ----------------------------------------
    def handle_lost(self, failed_set, t_fail, t_detect):
        for gid, g in self.groups.items():
            if g.state == "fallen-back":
                continue
            if any(m.server_id in failed_set
                   for m in g.members.values()) or (
                    g.pending is not None
                    and g.pending.server_id in failed_set):
                self._fail_ctx[gid] = t_fail
        return super().handle_lost(failed_set, t_fail, t_detect)

    def _teardown_engines(self, g: ShardGroup):
        """A member died and the ladder is NOT continuing seamlessly:
        the TP collective is broken, so the gathered engine must stop
        answering until it is rebuilt."""
        for m in g.members.values():
            w = self.tb.workers.get(m.server_id)
            if w is None or not w.alive:
                continue
            w.unload(g.base.name)
            for name in list(w.engines):
                if name.startswith(g.base.name + "::"):
                    w.unload(name)

    def _degrade(self, g, app, t_fail, t_detect):
        rec = super()._degrade(g, app, t_fail, t_detect)
        lead = g.lead

        def rebuild():
            t0 = time.monotonic()
            parts = self._collect_slices(g, zero_missing=True)
            if parts is None:
                return
            with torch.inference_mode():
                gathered = gather(parts, self._layout[app.id].axes)
            del parts
            self._install(g, lead.server_id, rec.variant, gathered)
            self._note("degrade_rebuild_s", time.monotonic() - t0)
            t_kill = self._fail_ctx.get(app.id, t_fail)
            self._note("degrade_mttr_s", time.monotonic() - t_kill)
            self._push_if_current(app.id)

        self.tb.executor._spawn(rebuild, f"degraded rebuild of {app.id}")
        return rec

    def _collect_slices(self, g: ShardGroup,
                        zero_missing: bool = False) -> Optional[list]:
        """The k rank slices off the member workers (pending member
        included); missing ranks come back zero-filled when allowed."""
        layout = self._layout.get(g.app_id)
        if layout is None:
            return None
        holders = dict(g.members)
        if g.pending is not None:
            holders[g.pending.rank] = g.pending
        parts = []
        for rank in range(g.tp_degree):
            m = holders.get(rank)
            sl = None
            if m is not None:
                w = self.tb.workers.get(m.server_id)
                if w is not None:
                    sl = w.shard(slice_name(g.base, rank, g.tp_degree))
            if sl is None:
                meta = layout.rank_meta.get(rank)
                if not zero_missing or meta is None:
                    return None
                with torch.inference_mode():
                    sl = zero_slice(meta)
            parts.append(sl)
        return parts

    def materialize_slice(self, app: Application, sv: Variant,
                          server_id: str) -> float:
        """Executor hook for a reshard's slice load: re-materialize the
        lost rank from the deterministic checkpoint seed and host it on
        the replacement worker. Returns wall seconds (the 'warmup' leg
        of the load ticket; the byte transfer was already slept at
        slice-byte cost by the executor's fetch plan)."""
        g = self.groups[app.id]
        rank = int(sv.name.rsplit("::shard", 1)[1].split("of")[0])
        w = self.tb.workers[server_id]
        t0 = time.monotonic()
        params = checkpoint_params(g.base, w.device)
        axes = self._layout[app.id].axes
        with torch.inference_mode():
            sl = rank_slice(params, axes, g.tp_degree, rank)
        del params                      # free the transient full draw
        self._layout[app.id].rank_meta[rank] = slice_meta(sl, axes)
        w.host_shard(sv.name, sl)
        _sync(w.device)
        wall = time.monotonic() - t0
        self._note("slice_fetch_s", wall)
        return wall

    def _reshard(self, g, app, rank, failed_set, t_fail, t_detect):
        self._teardown_engines(g)
        return super()._reshard(g, app, rank, failed_set, t_fail,
                                t_detect)

    def _after_repartition(self, g, sv, repart_s, finish):
        """The real repartition: re-gather all k slices (the pending
        member now hosts the re-materialized one), rebuild on the
        post-commit lead, then commit the controller-side state. The
        measured wall time calibrates the sim's modeled cost."""
        def work():
            t0 = time.monotonic()
            holders = dict(g.members)
            if g.pending is not None:
                holders[g.pending.rank] = g.pending
            lead_sid = holders[min(holders)].server_id
            parts = self._collect_slices(g)
            if parts is None:
                return         # a holder died; next epoch falls back
            with torch.inference_mode():
                gathered = gather(parts, self._layout[g.app_id].axes)
            del parts
            self._install(g, lead_sid, g.base.name, gathered)
            measured = time.monotonic() - t0
            with self.tb._ctl_lock:
                finish()
            self.calibrate_repartition(measured, sv.mem_bytes)
            self._note("repartition_s", measured)
            t_kill = self._fail_ctx.get(g.app_id, t0)
            self._note("reshard_mttr_s", time.monotonic() - t_kill)
            self._push_if_current(g.app_id)

        del repart_s
        self.tb.executor._spawn(work, f"repartition of {g.app_id}")

    def _fallback(self, g, app, t_fail, t_detect):
        self._teardown_engines(g)
        self._deferred.pop(app.id, None)
        return super()._fallback(g, app, t_fail, t_detect)

    # -- reporting ----------------------------------------------------------
    def summary(self) -> dict:
        out = super().summary()
        with self._meas_lock:
            out["measured"] = {
                k: {"n": len(v),
                    "avg_s": sum(v) / len(v) if v else -1.0,
                    "max_s": max(v) if v else -1.0}
                for k, v in self.measured.items()}
        return out
