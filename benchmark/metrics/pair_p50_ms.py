"""pair_p50_ms: median latency of the requests of the window (ms)."""

from benchmark.harness.readers import latencies_ms, percentile


def read(run):
    values = latencies_ms(run)
    return percentile(values, 50) if values else None
