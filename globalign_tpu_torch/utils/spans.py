"""Named host spans: ``globalign.<name>`` profiler ranges and phase times.

``span(name, phase_seconds)`` marks one stretch of the program's host
work.  Under a running ``torch.profiler`` it opens the
``record_function`` range ``globalign.<name>``: kineto records it as a
user annotation on the device trace's clock, so a trace shows which host
work the device waited on.  With no profiler running it opens none (a
``record_function`` costs ~13 us to enter and leave even then).  Given a
dict, it adds its host-clock seconds to ``phase_seconds[name]``.  It does
nothing else: no CUDA event, no synchronisation, no copy.

The span names (README, "Tracing"):

  * ``align_pairs`` phases, also the keys of its ``phase_seconds``:
    validate, scheme, bucket, pack, encode, fill, render, blocked, fetch,
    traceback, results;
  * inside its ``fill`` (never in ``phase_seconds``): ``fill.batch``,
    ``fill.wide``, ``fill.walk``;
  * a single-pair request: validate, scheme (inside validate), aligner,
    encode, fill (under the moves budget) or checkpoints and replays
    (blocked), fetch, traceback, results.
"""

from __future__ import annotations

import time

import torch

PREFIX = "globalign."


class span:
    """Context manager: the range ``globalign.<name>`` while a profiler runs,
    and the seconds inside added to ``phase_seconds[name]`` when a dict is
    given."""

    __slots__ = ("name", "phase_seconds", "_range", "_t0")

    def __init__(self, name: str, phase_seconds: dict | None = None):
        self.name = name
        self.phase_seconds = phase_seconds

    def __enter__(self):
        if self.phase_seconds is not None:
            self._t0 = time.perf_counter()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.phase_seconds is not None:
            seconds = time.perf_counter() - self._t0
            self.phase_seconds[self.name] = (
                self.phase_seconds.get(self.name, 0.0) + seconds
            )
        return False
