"""K4's chunked route (``kernels/rwkv6_scan``, the prefill's three
kernels) against its roofline over the traced slice: the bound time of the
chunked calls launched in the slice over the device time of
``wkv_chunk_{state,scan,out}_kernel`` in it."""

from bench import flops
from bench.trace import K4_CHUNKED_KERNEL


def read(run):
    if run.spans is None or run.device is None:
        return None
    a, b = run.device.t0, run.device.t0 + run.device.window_s
    calls = [s.info for s in run.spans.within("k4", a, b)
             if s.info["chunked"]]
    kernel_s = run.device.kernel_s(K4_CHUNKED_KERNEL)
    if not calls or kernel_s <= 0.0:
        return None
    bound = sum(flops.k4_bound_s(c["B"], c["S"], c["NH"], c["hs"], c["elt"])
                for c in calls)
    return 100.0 * bound / kernel_s
