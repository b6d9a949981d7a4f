"""kernels_per_request.pair: device kernels in the profiled slice, torch's
own included, over the requests in it."""

from benchmark.harness.readers import kernels_per_unit as read  # noqa: F401
