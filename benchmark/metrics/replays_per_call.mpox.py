"""replays_per_call.mpox: the profiled slice's ``globalign.replay`` ranges
(the blocked traceback opens one a replay block: its fill and its walk
queued) over the calls in the slice.  None where the slice has no such
range."""


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    lo, hi = run.slice.span
    count = sum(1 for kind, name, s, e in run.slice.events
                if kind == "range" and name == "globalign.replay" and lo <= s < hi)
    return count / run.slice.units if count else None
