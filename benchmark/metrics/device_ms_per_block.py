"""device_ms_per_block: device time (kernels, copies, memsets, summed from the
profiler's trace) over the blocks yielded in the traced slice (ms)."""


def read(rec):
    t = rec.trace
    if not t or rec.trace_blocks <= 0:
        return None
    total = sum(s for _n, s in t["kernels"].values())
    return 1e3 * total / rec.trace_blocks if total > 0 else None
