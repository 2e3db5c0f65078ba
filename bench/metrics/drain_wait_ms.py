"""Mean wait of a request from its first token (its prefill's end) to the
first decode step that carries it (``engine.first_decode_wait``), over the
window's requests: one serve thread drains a server's engines one at a
time, so a request waits there for the drains queued before its own, and
then for its step's lock."""

from bench import progtrace

progtrace.arm()


def read(run):
    v = progtrace.view(run)
    d = v.durations("engine.first_decode_wait") if v is not None else []
    return 1e3 * sum(d) / len(d) if d else None
