"""h2d_ms_per_block: device time of the host-to-device copies in the traced
slice (the profiler's `Memcpy HtoD ...` operations: each block's raw
capture, uploaded from pageable memory inside dispatch_fused's
block.upload, and the few small copies beside it) over the blocks yielded
in the slice (ms).  None where the trace has no such copy (the CPU)."""


def read(rec):
    t = rec.trace
    if not t or rec.trace_blocks <= 0:
        return None
    total = sum(s for name, (_n, s) in t["kernels"].items()
                if name.startswith("Memcpy HtoD"))
    return 1e3 * total / rec.trace_blocks if total > 0 else None
