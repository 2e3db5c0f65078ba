"""Tokens a decode step produced (the requests in flight in its slots),
over the engines' decode steps that started in the window."""


def read(run):
    if run.spans is None:
        return None
    steps = run.spans.within("decode", run.t0, run.t1)
    if not steps:
        return None
    return sum(len(s.info["contexts"]) for s in steps) / len(steps)
