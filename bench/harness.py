"""One run of one cell: set up the port's testbed, drive it for the window,
check what it served, and report the cell's metrics.

A cell (``bench/workloads/<cell>.json``) names a configuration
(``bench/configs``), a traffic mix (``bench/traffic``) and a fault schedule
(``bench/faults``); ``BENCHMARK.json`` names the metrics each cell reports,
and each metric is read by ``bench/metrics/<metric>.py``. Nothing here
knows a cell, a mix, a schedule or a metric by name.

The system under test is ``repro_torch.serving.testbed.MiniTestbed`` on the
card: the configuration's applications, each with its own variant ladder
(``core/variants.build_ladder``), deployed with their engines' slots and
cache length set from the cell before ``deploy()``. The benchmark's
open-loop clients, one thread an application, send each request when it is
due through ``Router.lookup`` and ``WorkerServer.submit``; a request that
finds its route dead or every slot busy is held and sent again every
``poll_s``; one admitted to a server that is killed before it completes is
sent again, keeping its due time. Crashes go through the testbed's own
kill path (``_fail_servers``), its failure detector, sweeper and
re-protection loops and the controller, and servers rejoin through
``_rejoin``. Where the fault schedule asks for probes, each kill also sends,
for each application routed to the killed server, one request of the mix's
shortest prompt, held and resent like any other: so the first answer after
a crash does not wait for the next request to fall due.
"""

from __future__ import annotations

import gc
import heapq
import importlib.util
import json
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, faults, ladder, traffic
from .plans import PlanLog
from .trace import Spans, breakdown, device_trace

BENCH = Path(__file__).resolve().parent
DRAIN_S = 60.0                  # how long answers due in the window may take
TRACE_SLICE = (0.40, 0.48)      # the profiled share of the window
TRACE_LEAD_S = 0.25             # the tracer starts this long before a request
WARMUP_IDX = 1 << 40            # request indices of the warm-up requests
PROBE_IDX = 1 << 41             # request indices of the crash probes


def log(msg: str):
    print(f"[bench {time.monotonic():.3f}] {msg}", file=sys.stderr, flush=True)


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    faults: Dict
    chips: int


def load_cell(name: str, root: Path = BENCH) -> Cell:
    w = read_json(root / "workloads" / f"{name}.json")
    return Cell(name, read_json(root / "configs" / f"{w['config']}.json"),
                read_json(root / "traffic" / f"{w['traffic']}.json"),
                read_json(root / "faults" / f"{w['faults']}.json"),
                int(w["chips"]))


def load_metric(name: str, root: Path = BENCH):
    """``bench/metrics/<name>.py``; its ``read(run)`` gives the value or
    None where the run has nothing to read."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metric entries of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end metrics untraced, its per-layer metrics traced."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
    e2e = {m["name"] for m in cell_metrics(bench, cell, False)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


# ---------------------------------------------------------------------------
# Requests and clients
# ---------------------------------------------------------------------------

@dataclass
class Record:
    """One request of the schedule, over all its attempts."""
    idx: int
    app: str
    t_due: float                    # host clock
    prompt: np.ndarray
    new_tokens: int
    attempts: int = 0
    sid: Optional[str] = None
    variant: Optional[str] = None
    req: object = None              # the engine's Request of the attempt
    t_sub: float = 0.0
    done: bool = False
    tokens: List[int] = field(default_factory=list)
    t_first: float = 0.0
    t_done: float = 0.0
    probe: bool = False


@dataclass
class Kill:
    t: float
    sid: str
    apps: List[str]


class Clients:
    """Open-loop clients, one thread an application, and a monitor that
    completes or resends what was admitted."""

    def __init__(self, tb, app_ids: List[str], poll_s: float,
                 errors: List[str]):
        self.tb = tb
        self.poll_s = poll_s
        self.errors = errors
        self.queues = {a: deque() for a in app_ids}
        self.cv = threading.Condition()
        self.lock = threading.Lock()
        self.inflight: Dict[int, Record] = {}
        self.kill_times: Dict[str, List[float]] = {}
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(a,),
                                         daemon=True) for a in app_ids]
        self.threads.append(threading.Thread(target=self._monitor,
                                             daemon=True))

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def release(self, rec: Record, front: bool = False):
        with self.cv:
            q = self.queues[rec.app]
            q.appendleft(rec) if front else q.append(rec)
            self.cv.notify_all()

    def note_kill(self, sid: str, t: float):
        with self.lock:
            self.kill_times.setdefault(sid, []).append(t)

    def _client(self, app: str):
        from repro_torch.serving.engine import Request
        q = self.queues[app]
        while True:
            with self.cv:
                while not q and not self.stop.is_set():
                    self.cv.wait(0.05)
                if self.stop.is_set():
                    return
                rec = q.popleft()
            while not self.stop.is_set():
                route = self.tb.router.lookup(app)
                if route is not None:
                    sid, vname = route
                    w = self.tb.workers[sid]
                    if w.alive and w.has(vname):
                        t = time.monotonic()
                        req = Request(id=f"{rec.idx}.{rec.attempts}",
                                      prompt=rec.prompt,
                                      max_new_tokens=rec.new_tokens,
                                      submitted_at=t)
                        try:
                            ok = w.submit(vname, req)
                        except Exception:             # noqa: BLE001
                            ok = False
                            self.errors.append(
                                f"submit of {app}: "
                                + traceback.format_exc(limit=1).strip())
                        if ok:
                            with self.lock:
                                rec.attempts += 1
                                rec.sid, rec.variant = sid, vname
                                rec.req, rec.t_sub = req, t
                                self.inflight[rec.idx] = rec
                            break
                time.sleep(self.poll_s)

    def _monitor(self):
        while not self.stop.is_set():
            with self.lock:
                items = list(self.inflight.values())
                kills = {s: list(v) for s, v in self.kill_times.items()}
            for rec in items:
                req = rec.req
                kt = next((k for k in kills.get(rec.sid, ())
                           if k >= rec.t_sub), None)
                done_at = req.done_at
                if done_at is not None and (kt is None or done_at <= kt):
                    with self.lock:
                        self.inflight.pop(rec.idx, None)
                        rec.tokens = list(req.tokens)
                        rec.t_first = req.first_token_at
                        rec.t_done = done_at
                        rec.done = True
                elif kt is not None:
                    with self.lock:
                        self.inflight.pop(rec.idx, None)
                    self.release(rec, front=True)
            time.sleep(0.005)

    def close(self):
        self.stop.set()
        with self.cv:
            self.cv.notify_all()
        for t in self.threads:
            t.join(timeout=10.0)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What one run measured; each metric reader reads from it."""
    cell: Cell
    seed: int
    seconds: float
    setup_s: float
    t0: float                       # window start, host clock
    t1: float                       # window end
    records: List[Record]           # the mix's requests
    kills: List[Kill]
    recoveries: List                # the controller's RecoveryRecords
    accuracy: Callable[[str], float]
    spans: Optional[Spans] = None
    device: Optional[object] = None  # trace.DeviceTrace
    extra: Dict = field(default_factory=dict)
    probes: List[Record] = field(default_factory=list)

    @property
    def done(self) -> List[Record]:
        """The mix's requests that were answered."""
        return [r for r in self.records if r.done]


def model_config(config: Dict):
    from repro_torch.models.config import ModelConfig
    m = dict(config["model"])
    m["block_pattern"] = tuple(m["block_pattern"])
    return ModelConfig(**m)


def build_apps(config: Dict):
    """The deployment's applications: each its own model of the
    configuration (its own ladder and weights, named after it)."""
    from repro_torch.core.variants import Application, build_ladder
    cfg = model_config(config)
    dep = config["deployment"]
    apps = []
    for i in range(dep["apps"]):
        ladder_i = build_ladder(cfg.replace(name=f"{cfg.name}.app{i}"))
        apps.append(Application(id=f"app{i}", family=cfg.name,
                                variants=ladder_i, request_rate=1.0,
                                critical=i < dep["critical_apps"]))
    return apps


def build_testbed(cell: Cell, device: str):
    from repro_torch.serving.testbed import MiniTestbed
    dep = cell.config["deployment"]
    apps = build_apps(cell.config)
    tb = MiniTestbed(apps=apps, n_sites=dep["sites"],
                     servers_per_site=dep["servers_per_site"],
                     policy=dep["policy"], planner=dep["planner"],
                     alpha=dep["alpha"], device=device,
                     planner_backend=dep["planner_backend"], seed=0)
    for w in tb.workers.values():
        w.batch_slots = dep["batch_slots"]
        w.max_len = cell.traffic["max_len"]
    tb.deploy()
    return tb, apps


def trace_start(sched, seconds: float) -> float:
    """When the traced slice opens: just before the first request due at or
    after ``TRACE_SLICE[0]`` of the window, so that the slice holds device
    work even where the mix's gaps are longer than the slice."""
    span = (TRACE_SLICE[1] - TRACE_SLICE[0]) * seconds
    due = [a.t_due for a in sched if a.t_due >= TRACE_SLICE[0] * seconds]
    t = min(due[0] if due else TRACE_SLICE[0] * seconds, seconds - span)
    return max(0.0, t - TRACE_LEAD_S)


def start_loops(tb):
    """The testbed's sweeper (detection -> failover) and re-protection
    loops, joined by ``tb.shutdown()``."""
    from repro_torch.serving.testbed import REPROTECT_EVERY_S
    for target, args in ((tb._sweeper_loop, ()),
                         (tb._reprotect_loop, (REPROTECT_EVERY_S,))):
        t = threading.Thread(target=target, args=args, daemon=True)
        tb._aux_threads.append(t)
        t.start()


def warm_up(clients: Clients, apps, mix: Dict, seed: int, vocab: int,
            timeout: float = 600.0):
    """The mix's shapes through every application's served path: each
    length of ``warmup_prompts`` once an application, with the mix's
    largest output, until answered. Counted as set-up."""
    recs = []
    n_new = int(mix["new_tokens"]["max"])
    for j, length in enumerate(mix["warmup_prompts"]):
        for i, app in enumerate(apps):
            idx = WARMUP_IDX + j * len(apps) + i
            rec = Record(idx, app.id, time.monotonic(),
                         traffic.prompt_tokens(seed, idx, int(length), vocab),
                         n_new)
            recs.append(rec)
            clients.release(rec)
        deadline = time.monotonic() + timeout
        while not all(r.done for r in recs):
            if time.monotonic() > deadline:
                raise RuntimeError("warm-up requests were not answered")
            time.sleep(0.01)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = BENCH,
             bench_json: Optional[Path] = None,
             t_start: Optional[float] = None,
             control: bool = False, rate_rps: Optional[float] = None,
             fault_schedule: Optional[Dict] = None,
             check_outputs: bool = True) -> Dict:
    """One run; returns the result line's object (without ``checks``
    printed). ``t_start`` is the host clock at which set-up began;
    ``control`` judges the fp8 control's first choices in place of the
    program's tokens (``run.py --control 1``);
    ``rate_rps`` and ``fault_schedule`` replace the mix's rate and the
    cell's faults, and ``check_outputs=False`` skips the reference
    (``bench/sweep.py``)."""
    t_start = time.monotonic() if t_start is None else t_start
    bench = read_json(bench_json or (root.parent / "BENCHMARK.json"))
    cell = load_cell(name, root)
    if rate_rps is not None:
        cell.traffic = dict(cell.traffic, rate_rps=rate_rps)
    if fault_schedule is not None:
        cell.faults = fault_schedule
    wanted = cell_metrics(bench, name, trace)
    readers = {m["name"]: load_metric(m["name"], root) for m in wanted}
    dev = torch.device(device)

    # --- set-up --------------------------------------------------------
    errors: List[str] = []
    tb, apps = build_testbed(cell, device)
    plans = PlanLog().install(tb.controller)
    log(f"deployed {len(apps)} applications "
        f"({time.monotonic() - t_start:.3f} s after start)")
    vocab = cell.config["model"]["vocab_size"]
    start_loops(tb)
    clients = Clients(tb, [a.id for a in apps], cell.traffic["poll_s"],
                      errors).start()
    spans = None
    try:
        warm_up(clients, apps, cell.traffic, seed, vocab)
        log("warm-up requests answered")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if trace:
            # the tracer's first start (CUPTI's) is set-up, not window
            with _profiler(dev):
                torch.zeros(1, device=dev).add_(1)
            spans = Spans().install()
        sched = traffic.schedule(cell.traffic, seed, seconds, len(apps))
        crashes = faults.crashes(cell.faults, seconds)
        picker = faults.VictimPicker(seed)
        crit = {a.id: a.critical for a in apps}
        t0 = time.monotonic()
        setup_s = t0 - t_start
        t1 = t0 + seconds
        records = [Record(a.idx, apps[a.app].id, t0 + a.t_due,
                          traffic.prompt_tokens(seed, a.idx, a.prompt_len,
                                                vocab), a.new_tokens)
                   for a in sched]
        kills: List[Kill] = []
        probes: List[Record] = []
        probe_new = cell.faults.get("probe_new_tokens")
        events = [(r.t_due, 0, i, "arrive") for i, r in enumerate(records)]
        events += [(t0 + c.t, 1, i, "crash") for i, c in enumerate(crashes)]
        if trace:
            events.append((t0 + trace_start(sched, seconds), 3, 0,
                           "trace_on"))
        heapq.heapify(events)
        prof = slice_t = None

        # --- the window: arrivals, crashes, rejoins, the traced slice ----
        while events:
            t_ev, _, i, what = heapq.heappop(events)
            delay = t_ev - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if what == "arrive":
                clients.release(records[i])
            elif what == "crash":
                kill = _crash(tb, clients, crashes[i], picker, crit)
                if kill is not None:
                    kills.append(kill)
                    if probe_new:
                        for app in kill.apps:
                            idx = PROBE_IDX + len(probes)
                            probes.append(Record(
                                idx, app, kill.t, traffic.prompt_tokens(
                                    seed, idx, int(cell.traffic["prompt"][
                                        "min"]), vocab),
                                int(probe_new), probe=True))
                            clients.release(probes[-1], front=True)
                    if crashes[i].rejoin_t is not None:
                        heapq.heappush(events, (t0 + crashes[i].rejoin_t, 2,
                                                len(kills) - 1, "rejoin"))
            elif what == "rejoin":
                tb._rejoin(kills[i].sid)
            elif what == "trace_on":
                prof = _profiler(dev)
                prof.__enter__()
                slice_t = [time.monotonic(), None]
                heapq.heappush(events, (
                    slice_t[0] + (TRACE_SLICE[1] - TRACE_SLICE[0]) * seconds,
                    3, 0, "trace_off"))
            elif what == "trace_off":
                slice_t[1] = time.monotonic()     # the tracer's stop is not
                prof.__exit__(None, None, None)   # part of the slice
        delay = t1 - time.monotonic()
        if delay > 0:
            time.sleep(delay)

        log(f"window closed: {sum(r.done for r in records)} of "
            f"{len(records)} answered, {len(kills)} crashes")
        # --- drain: every answer due in the window, up to DRAIN_S late ---
        deadline = t1 + DRAIN_S
        while not all(r.done for r in records + probes) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        clients.close()
        if spans is not None:
            spans.remove()
    with tb._ctl_lock:
        recoveries = list(tb.controller.flat_records())
    extra = {"errors": errors + list(tb.errors),
             "routes_bad": _routes_bad(tb), "over_capacity": _over_cap(tb)}
    tb.shutdown()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    model = cell.config["model"]
    acc = {}

    def accuracy(variant: str) -> float:
        if variant not in acc:
            acc[variant] = ladder.accuracy(model, ladder.tag_of(variant))
        return acc[variant]

    dtrace = None
    if trace and prof is not None:
        dtrace = device_trace(prof, *slice_t)
        del prof
    run = Run(cell, seed, seconds, setup_s, t0, t1, records, kills,
              recoveries, accuracy, spans, dtrace, extra, probes)

    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # --- correctness: the program's state is gone; the reference runs ---
    del tb, apps, clients
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sent = records + probes
    done = [r for r in sent if r.done]
    log(f"drained; {len(done)} of {len(sent)} answered; "
        f"peak {peak / 2**30:.3f} GiB")
    bad_plans = plans.mismatches(model)
    run.extra["plan_rounds"] = len(plans.rounds)
    log(f"{len(plans.rounds)} planning rounds held to the plain planner")
    log("readings " + json.dumps(_readings(run, root)))
    sample = check.pick_sample(done, seed,
                               int(cell.traffic["check_positions"])) \
        if check_outputs else []
    rows = check.gaps(cell.config, sample, dev, control=control)
    # the control puts the fp8 reference's first choices where the
    # program's tokens were, and is judged by the same checks
    gap = check.widest(rows, "control_gap" if control else "served_gap")
    log(f"reference over {len(rows)} requests, "
        f"{sum(r['tokens'] for r in rows)} served tokens, done")
    limit = float(cell.config["check"]["logit_gap_limit"])
    bad_len = sum(len(r.tokens) != r.new_tokens + 1 for r in done)
    checks = {
        "logit_gap": {"value": gap if gap is not None else float("nan"),
                      "limit": limit},
        "unanswered": {"value": len(sent) - len(done), "limit": 0},
        "wrong_length": {"value": bad_len, "limit": 0},
        "program_errors": {"value": len(extra["errors"]), "limit": 0},
        "dead_routes": {"value": extra["routes_bad"], "limit": 0},
        "over_capacity": {"value": extra["over_capacity"], "limit": 0},
        "plan_mismatch": {"value": bad_plans, "limit": 0},
    }
    correct = (gap is not None and gap <= limit
               and all(c["value"] <= c["limit"] for k, c in checks.items()
                       if k != "logit_gap"))
    out = {"correct": bool(correct), "attempted": len(sent),
           "failed": len(sent) - len(done), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if dtrace is not None:
        out["device"]["busy_s"] = dtrace.busy_s
        out["device"]["window_s"] = dtrace.window_s
        out["breakdown"] = breakdown(dtrace, spans)
    out["checks"] = checks
    out["_sample"] = rows
    out["_errors"] = extra["errors"][:5]
    out["_run"] = run
    return out


def _readings(run: Run, root: Path) -> Dict:
    """Every metric of ``bench/metrics`` that the run has something for,
    with each request's time to first token and each crash's probe's, for
    the log."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        v = load_metric(path.stem, root).read(run)
        if v is not None:
            out[path.stem] = float(v)
    out["ttft_ms"] = sorted(round((r.t_first - r.t_due) * 1e3, 3)
                            for r in run.done)
    out["probe_ms"] = [round((p.t_first - p.t_due) * 1e3, 3)
                       for p in run.probes if p.done]
    return out


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                               else ProfilerActivity.CPU])


def _crash(tb, clients: Clients, crash, picker, crit) -> Optional[Kill]:
    _, routes = tb.router.snapshot()
    holders = {"critical": [], "standard": []}
    for app, (sid, _v) in routes.items():
        if tb.workers[sid].alive:
            holders["critical" if crit[app] else "standard"].append(sid)
    holders = {k: sorted(set(v)) for k, v in holders.items()}
    sid = picker.pick(crash.target, holders)
    if sid is None:
        return None
    affected = sorted(a for a, (s, _v) in routes.items() if s == sid)
    t = time.monotonic()
    clients.note_kill(sid, t)
    tb._fail_servers([sid])
    return Kill(t, sid, affected)


def _routes_bad(tb) -> int:
    """Applications whose route, once every answer is in, points to a
    server that is down or does not hold the routed variant."""
    _, routes = tb.router.snapshot()
    bad = 0
    for app in tb.apps:
        r = routes.get(app.id)
        if r is None or not (tb.workers[r[0]].alive
                             and tb.workers[r[0]].has(r[1])):
            bad += 1
    return bad


def _over_cap(tb) -> int:
    """Live servers whose placed variants exceed their memory capacity:
    a failover plan that broke the planner's constraint."""
    with tb._ctl_lock:
        return sum(1 for s in tb.cluster.servers.values()
                   if s.alive and s.used("mem") > s.capacity["mem"] + 1e-6)
