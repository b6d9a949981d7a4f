"""The profiled slice: device activity and host ranges from ``torch.profiler``,
and the arithmetic the per-layer metrics share.

Events are kept as plain tuples ``(kind, name, start_ns, end_ns)`` with
``kind`` one of ``kernel``, ``memcpy``, ``memset`` (device work) or
``range`` (a host ``record_function`` range).  No trace file is written.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "memcpy", "memset")
SLICE_RANGE = "bench.slice"


@dataclass
class Slice:
    """What one profiled slice holds: its events, its span (the
    ``bench.slice`` range), how many calls or requests ran in it, and the
    true cells (sum of m * n) of their pairs."""

    events: list = field(default_factory=list)
    units: int = 0
    cells: int = 0

    @property
    def span(self) -> tuple[int, int]:
        spans = [(s, e) for kind, name, s, e in self.events
                 if kind == "range" and name == SLICE_RANGE]
        if len(spans) != 1:
            raise ValueError(f"expected one {SLICE_RANGE} range, found {len(spans)}")
        return spans[0]

    def device(self) -> list[tuple[int, int]]:
        """Device intervals (kernels, copies, sets), clipped to the span."""
        lo, hi = self.span
        return [(max(s, lo), min(e, hi)) for kind, _, s, e in self.events
                if kind in DEVICE_KINDS and e > lo and s < hi]

    def kernels(self) -> list[tuple[str, int]]:
        """(name, ns) of every kernel inside the span."""
        lo, hi = self.span
        return [(name, min(e, hi) - max(s, lo)) for kind, name, s, e in self.events
                if kind == "kernel" and e > lo and s < hi]


def _kind(event) -> str | None:
    device = str(event.device_type())
    activity = str(event.activity_type()) if hasattr(event, "activity_type") else ""
    name = event.name()
    if device.endswith("CPU"):
        if activity == "user_annotation" or name.startswith(("globalign.", "bench.")):
            return "range"
        return None
    if "annotation" in activity or name.startswith(("globalign.", "bench.")):
        return None  # the device's copy of a host range
    if "memcpy" in activity.lower() or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in activity.lower() or name.startswith("Memset"):
        return "memset"
    return "kernel"


@contextmanager
def profiled(slice_: Slice):
    """Profile the body (CPU and CUDA activity) into ``slice_.events``,
    inside one ``bench.slice`` range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if card else []))
    prof.start()
    try:
        with record_function(SLICE_RANGE):
            yield
            sync()
    finally:
        prof.stop()
    for event in prof.profiler.kineto_results.events():
        kind = _kind(event)
        if kind is not None:
            slice_.events.append((kind, event.name(), event.start_ns(), event.end_ns()))


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def idle_by_range(slice_: Slice) -> dict[str, int]:
    """Idle device ns in the slice, split by the innermost host range open
    at the time (the latest started of those covering it); ``none`` where
    only the slice's own range is open."""
    lo, hi = slice_.span
    ranges = [(s, e, name) for kind, name, s, e in slice_.events
              if kind == "range" and name != SLICE_RANGE and e > lo and s < hi]
    out: dict[str, int] = {}
    for g0, g1 in gaps(slice_.device(), lo, hi):
        cuts = sorted({g0, g1, *(x for s, e, _ in ranges for x in (s, e) if g0 < x < g1)})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            open_ = [(s, name) for s, e, name in ranges if s <= mid < e]
            name = max(open_)[1] if open_ else "none"
            out[name] = out.get(name, 0) + (b - a)
    return out


def busy_s(slice_: Slice) -> float:
    return union_ns(slice_.device()) / 1e9


def window_s(slice_: Slice) -> float:
    lo, hi = slice_.span
    return (hi - lo) / 1e9


def idle_share(slice_: Slice) -> float:
    """Percent of the slice in which the device runs nothing."""
    lo, hi = slice_.span
    return 100.0 * (1.0 - union_ns(slice_.device()) / (hi - lo))


def kernel_count(slice_: Slice) -> int:
    return len(slice_.kernels())


def kernel_seconds(slice_: Slice) -> float:
    return sum(ns for _, ns in slice_.kernels()) / 1e9


def top(totals: dict[str, float], k: int = 10) -> list[list]:
    return [[name, value] for name, value in
            sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def breakdown(slice_: Slice) -> dict:
    """The device operations that took most time, and the idle time by host
    range, in seconds, ten of each at most."""
    ops: dict[str, float] = {}
    lo, hi = slice_.span
    for kind, name, s, e in slice_.events:
        if kind in DEVICE_KINDS and e > lo and s < hi:
            ops[name] = ops.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
    idle = {name: ns / 1e9 for name, ns in idle_by_range(slice_).items()}
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
