"""device_idle.genome: share of the profiled slice in which the device runs
nothing: no kernel, copy or set (%)."""

from benchmark.harness.readers import device_idle as read  # noqa: F401
