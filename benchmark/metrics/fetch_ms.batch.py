"""fetch_ms.batch: the fetch phase (waiting on the device and the copy
back) a call, over the calls outside the profiled slice (ms)."""

from benchmark.harness.readers import fetch_ms as read  # noqa: F401
