"""Mean of ``RecoveryRecord.phases["plan"]`` over the window's cold
recoveries: the failover round's plan wall (K5's round on the card)."""


def read(run):
    d = [r.phases["plan"] for r in run.recoveries
         if r.mode.startswith("cold") and "plan" in r.phases]
    return 1e3 * sum(d) / len(d) if d else None
