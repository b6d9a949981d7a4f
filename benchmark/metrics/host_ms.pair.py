"""host_ms.pair: the program's host work a request in the profiled slice
(ms): the union of its ``globalign.*`` ranges less the union of its
``globalign.fetch`` ranges (the wait for the device and the copy back),
over the requests in the slice.  None where the slice has no such range."""

from benchmark.harness import trace


def _union_ns(slice_, keep) -> int | None:
    """Length of the union of the slice's host ranges whose name ``keep``
    accepts, clipped to the slice; None where there is none."""
    lo, hi = slice_.span
    ranges = [(max(s, lo), min(e, hi)) for kind, name, s, e in slice_.events
              if kind == "range" and keep(name) and e > lo and s < hi]
    return trace.union_ns(ranges) if ranges else None


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    program = _union_ns(run.slice, lambda name: name.startswith("globalign."))
    if program is None:
        return None
    fetch = _union_ns(run.slice, lambda name: name == "globalign.fetch") or 0
    return (program - fetch) / 1e6 / run.slice.units
