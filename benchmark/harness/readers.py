"""The arithmetic of the metrics, shared by the readers in ``metrics/``.

Each reader takes a ``core.Run`` and returns a number, or None where the
run holds nothing to read (no profiled slice, no kernel time): the metric
is then left out of the result line.
"""

from __future__ import annotations

import statistics

from . import trace


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile, linear between order statistics (the
    inclusive method: numpy's default)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def latencies_ms(run) -> list[float]:
    return [1e3 * r.seconds for r in run.records if r.in_window]


def gcups(run) -> float | None:
    """True cells of every call resolved in the window, over its length."""
    cells = sum(r.cells for r in run.records if r.in_window and r.ok)
    return cells / run.window_s / 1e9 if run.window_s > 0 and cells else None


def _outside_slice(run):
    return [r for r in run.records if r.phases and not r.in_slice]


def host_ms(run) -> float | None:
    """The program's host phases but the fetch, a call."""
    calls = _outside_slice(run)
    if not calls:
        return None
    return 1e3 * sum(sum(v for k, v in r.phases.items() if k != "fetch")
                     for r in calls) / len(calls)


def fetch_ms(run) -> float | None:
    calls = _outside_slice(run)
    if not calls:
        return None
    return 1e3 * sum(r.phases.get("fetch", 0.0) for r in calls) / len(calls)


def kernels_per_unit(run) -> float | None:
    if run.slice is None or not run.slice.units:
        return None
    count = trace.kernel_count(run.slice)
    return count / run.slice.units if count else None


def dp_roofline(run) -> float | None:
    """Percent: the slice's true cells at the ceiling cell rate, over the
    time its kernels ran."""
    if run.slice is None or not run.ceiling:
        return None
    busy = trace.kernel_seconds(run.slice)
    return 100.0 * run.slice.cells / run.ceiling / busy if busy > 0 else None


def device_idle(run) -> float | None:
    if run.slice is None or not any(k == "kernel" for k, *_ in run.slice.events):
        return None
    return trace.idle_share(run.slice)
