"""dp_roofline.mpox: the slice's true cells at the ceiling cell rate
(harness/peaks.py) over its kernels' time (%): the blocked route's share
of its roofline, the checkpoint pass, replays and walks together."""

from benchmark.harness.readers import dp_roofline as read  # noqa: F401
