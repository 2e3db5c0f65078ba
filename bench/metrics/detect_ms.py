"""Mean of the controller's ``RecoveryRecord.phases["detect"]`` over the
window's recoveries: kill to the failure detector's verdict, as swept."""


def read(run):
    d = [r.phases["detect"] for r in run.recoveries if "detect" in r.phases]
    return 1e3 * sum(d) / len(d) if d else None
