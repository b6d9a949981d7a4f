"""dp_roofline.batch: the slice's true cells at the ceiling cell rate
(harness/peaks.py) over its kernels' time (%)."""

from benchmark.harness.readers import dp_roofline as read  # noqa: F401
