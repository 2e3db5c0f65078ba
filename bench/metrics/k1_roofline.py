"""K1 (``kernels/flash_attention``) against its roofline over the traced
slice: the bound time of the K1 calls launched in the slice (``bench/
flops.py``, from each call's shapes) over the device time of K1's kernels
in the slice (``fa_kernel``, ``fa_tc_kernel``). Calls in flight at the
slice's edges make the two sets differ by a kernel or two."""

from bench import flops
from bench.trace import K1_KERNEL


def read(run):
    if run.spans is None or run.device is None:
        return None
    a, b = run.device.t0, run.device.t0 + run.device.window_s
    calls = [s.info for s in run.spans.within("k1", a, b)
             if not s.info["window"]]
    kernel_s = run.device.kernel_s(K1_KERNEL)
    if not calls or kernel_s <= 0.0:
        return None
    bound = sum(flops.k1_bound_s(c["B"], c["Sq"], c["Skv"], c["H"],
                                 c["KVH"], c["hd"], c["causal"], c["elt"])
                for c in calls)
    return 100.0 * bound / kernel_s
