"""Client MTTR: for each crash and each application whose route was on the
killed server, the time from the kill to the first token of that
application's first request completed after it (sent after the kill, so
on a live route), the mix's requests and the crash's probe alike; the mean
over all such samples of the window. The probe, sent at the kill, makes
each sample a recovery and not a wait for the next request to fall due."""


def read(run):
    answered = run.done + [p for p in run.probes if p.done]
    samples = []
    for k in run.kills:
        for app in k.apps:
            after = [r for r in answered
                     if r.app == app and r.t_sub >= k.t]
            if after:
                first = min(after, key=lambda r: r.t_done)
                samples.append(first.t_first - k.t)
    if not samples:
        return None
    return 1e3 * sum(samples) / len(samples)
