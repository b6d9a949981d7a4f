"""segments_per_call.genome: the profiled slice's ``globalign.fill`` ranges
(a traceback call opens one a segment: its ragged fill and walk) over the
calls in the slice.  None where the slice has no such range."""


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    lo, hi = run.slice.span
    count = sum(1 for kind, name, s, e in run.slice.events
                if kind == "range" and name == "globalign.fill" and lo <= s < hi)
    return count / run.slice.units if count else None
