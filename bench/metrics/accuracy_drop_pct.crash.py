"""Mean over the completed requests of 100 x (1 - accuracy of the rung that
served it relative to ``:full``), by the frozen ladder rule
(``bench/ladder.py``)."""


def read(run):
    done = run.done
    if not done:
        return None
    return 100.0 * sum(1.0 - run.accuracy(r.variant) for r in done) / len(done)
