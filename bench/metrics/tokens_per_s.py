"""Tokens generated by the requests completed within the window (every
token of each, the prefill's first included), over the window's seconds."""


def read(run):
    n = sum(len(r.tokens) for r in run.done if r.t_done <= run.t1)
    return n / run.seconds
