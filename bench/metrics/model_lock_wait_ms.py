"""Mean wait for an engine's ``_model_lock`` (``engine.lock_wait``), over
the prefills and decode steps that took it in the window: a prefill on a
client's thread and a decode step on the serve thread hold it in turn."""

from bench import progtrace

progtrace.arm()


def read(run):
    v = progtrace.view(run)
    d = v.durations("engine.lock_wait") if v is not None else []
    return 1e3 * sum(d) / len(d) if d else None
