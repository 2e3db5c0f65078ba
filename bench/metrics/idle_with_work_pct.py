"""Share of the traced slice in which no kernel ran on the card while at
least one request was admitted and unfinished: the slice's idle stretches
(``idle_share``'s) mapped onto the program's clock, covered by the union
of its ``request`` spans (admission to the step that finishes it). At most
``idle_share``; the rest of the idle had no request in the system."""

from bench import progtrace

progtrace.arm()


def read(run):
    v = progtrace.view(run)
    if v is None or v.gaps is None or run.device.window_s <= 0.0:
        return None
    busy = progtrace.intervals(v.spans, "request")
    return 100.0 * progtrace.overlap(v.gaps, busy) / run.device.window_s
