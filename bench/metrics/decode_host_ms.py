"""Mean host time to issue a decode step (``engine.decode.enqueue``:
``decode_step`` and the argmax until they return, after the last tokens'
upload and before the new ones are read back: no copy in it waits for the
card), over the window's decode steps."""

from bench import progtrace

progtrace.arm()


def read(run):
    v = progtrace.view(run)
    d = v.durations("engine.decode.enqueue") if v is not None else []
    return 1e3 * sum(d) / len(d) if d else None
