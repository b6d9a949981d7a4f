"""walk_ms.genome: the union of the profiled slice's ``globalign.fill.walk``
ranges (queueing each segment's ragged walk) over the calls in the slice
(ms).  None where the slice has no such range."""

from benchmark.harness import trace


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    lo, hi = run.slice.span
    ranges = [(max(s, lo), min(e, hi)) for kind, name, s, e in run.slice.events
              if kind == "range" and name == "globalign.fill.walk" and e > lo
              and s < hi]
    if not ranges:
        return None
    return trace.union_ns(ranges) / 1e6 / run.slice.units
