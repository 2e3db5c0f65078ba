"""Mean time from when a request was due to when the attempt that completed
it was admitted (``WorkerServer.submit`` called with a slot free): the
client and router layer's wait, outages included."""


def read(run):
    done = run.done
    if not done:
        return None
    return 1e3 * sum(r.t_sub - r.t_due for r in done) / len(done)
