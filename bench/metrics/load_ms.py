"""Mean of queue + fetch + warmup of ``RecoveryRecord.phases`` over the
window's cold recoveries: the first rung's load on its new server."""


def read(run):
    d = [r.phases["queue"] + r.phases["fetch"] + r.phases["warmup"]
         for r in run.recoveries
         if r.mode.startswith("cold")
         and all(k in r.phases for k in ("queue", "fetch", "warmup"))]
    return 1e3 * sum(d) / len(d) if d else None
