"""k1_roofline_share: the sync scan K1's bound at its block shape (bytes once
over the HBM peak, or float32 operations over the float32 peak) over its
mean kernel time in the trace (%)."""
from vbench.roofline import k1_bound_s

KERNEL = "sync_scan_kernel"


def read(rec):
    t = rec.trace
    if not t or rec.k1_shape is None:
        return None
    hits = [(n, s) for name, (n, s) in t["kernels"].items() if KERNEL in name]
    count = sum(n for n, _s in hits)
    total = sum(s for _n, s in hits)
    if count == 0 or total <= 0:
        return None
    c, tt = rec.k1_shape
    return 100.0 * k1_bound_s(c, tt, rec.config["sync_impl"]) / (total / count)
