"""replay_ms.mpox: the union of the profiled slice's ``globalign.replay``
ranges (the host queueing each replay block's fill and walk) over the
calls in the slice (ms).  None where the slice has no such range."""

from benchmark.harness import trace


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    lo, hi = run.slice.span
    ranges = [(max(s, lo), min(e, hi)) for kind, name, s, e in run.slice.events
              if kind == "range" and name == "globalign.replay" and e > lo
              and s < hi]
    if not ranges:
        return None
    return trace.union_ns(ranges) / 1e6 / run.slice.units
