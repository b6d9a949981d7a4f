"""fetch_ms.genome: the fetch phase (the host's wait for the device and the
copy back) a call, over the calls outside the profiled slice (ms)."""

from benchmark.harness.readers import fetch_ms as read  # noqa: F401
