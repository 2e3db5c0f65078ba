"""Mean host time to issue a prefill (``engine.prefill.enqueue``: the
slot's reset, ``prefill`` and the cache write, until they return, after
the prompt's upload and before the first token is read back: no copy in
it waits for the card), over the window's admissions."""

from bench import progtrace

progtrace.arm()


def read(run):
    v = progtrace.view(run)
    d = v.durations("engine.prefill.enqueue") if v is not None else []
    return 1e3 * sum(d) / len(d) if d else None
