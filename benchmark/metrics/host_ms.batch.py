"""host_ms.batch: the batch front end's host phases (phase_seconds but
fetch) a call, over the calls outside the profiled slice (ms)."""

from benchmark.harness.readers import host_ms as read  # noqa: F401
