"""pair_p95_ms: 95th percentile latency of the requests of the window (ms)."""

from benchmark.harness.readers import latencies_ms, percentile


def read(run):
    values = latencies_ms(run)
    return percentile(values, 95) if values else None
