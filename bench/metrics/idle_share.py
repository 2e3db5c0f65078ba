"""Share of the traced slice in which no kernel ran on the card: one less
the union of the kernels' intervals over the slice."""


def read(run):
    if run.device is None or run.device.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
