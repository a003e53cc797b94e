"""frame_latency_p50_ms: per burst whose last sample was fed inside the
window, the time of its line minus the due time of the feeder's write that
held that sample; the median (ms).  A burst never printed counts at its age
when the run stopped waiting."""
from vbench.drive import quantile


def read(rec):
    return quantile(rec.latencies_ms, 0.50) if rec.latencies_ms else None
