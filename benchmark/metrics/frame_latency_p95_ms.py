"""frame_latency_p95_ms: the 95th percentile of frame_latency_p50_ms's
per-burst latencies (ms)."""
from vbench.drive import quantile


def read(rec):
    return quantile(rec.latencies_ms, 0.95) if rec.latencies_ms else None
