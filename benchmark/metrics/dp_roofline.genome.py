"""dp_roofline.genome: the slice's true cells at the ceiling cell rate
(harness/peaks.py) over its kernels' time (%): the traceback route's
share of its roofline, whatever kernel fills the genomes."""

from benchmark.harness.readers import dp_roofline as read  # noqa: F401
