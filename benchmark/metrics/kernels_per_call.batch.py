"""kernels_per_call.batch: device kernels in the profiled slice, torch's
own included, over the calls in it."""

from benchmark.harness.readers import kernels_per_unit as read  # noqa: F401
