"""Drive ``align_pairs`` as the batch runner does (``BatchRunner.run``),
without its TSV and journal: calls of ``pairs_per_call`` pairs, each
queued with ``flush=False`` and resolved after the next one is queued (a
one-deep pipeline), the scheme resolved a call over the call's letters, or
once for a matrix (``BatchRunner._chunk_scheme``).  The pool's calls are
taken in turn; the program keeps nothing between calls.

The window starts once the first call is queued and ends at the first
resolve past its length; the call then in flight is resolved after it and
counted as attempted, not as done in the window.  A traced run drains the
pipeline, profiles ``trace_calls`` calls and goes on until the window's
length.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness import trace
from benchmark.harness.core import Record

MATRIX_KEYS = ("scoring_mat_name", "scoring_mat_path")


def _answer(result):
    return (result.cost, result.score, result.seq_1_aligned,
            result.middle_part, result.seq_2_aligned)


def warm_up(ctx) -> None:
    """Every call of the pool once, so that every size the window meets has
    been allocated."""
    port, options = ctx.port, ctx.config["scheme"]
    matrix = any(key in options for key in MATRIX_KEYS)
    cached = []

    def scheme_for(call):
        if cached:
            return cached[0]
        with torch.profiler.record_function("bench.scheme"):
            scheme = port.resolve_scheme("".join(a for a, _ in call).upper(),
                                         "".join(b for _, b in call).upper(),
                                         **options)
        if matrix:
            cached.append(scheme)
        return scheme

    def dispatch(k):
        call = ctx.pool[k % len(ctx.pool)]
        phases, t = {}, time.perf_counter()
        try:
            scheme = scheme_for(call)
            pending = port.align_pairs(
                call, scheme=scheme, with_traceback=ctx.traffic["with_traceback"],
                device=ctx.device, phase_seconds=phases, flush=False)
        except Exception as exc:  # counted as failed when resolved
            pending = exc
        return k, call, pending, phases, t

    ctx.dispatch = dispatch
    ctx.cells = [sum(len(a) * len(b) for a, b in call) for call in ctx.pool]
    for k in range(min(int(ctx.traffic["warmup_calls"]), len(ctx.pool))):
        pending = dispatch(k)[2]
        if isinstance(pending, Exception):
            raise pending
        pending.resolve()
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def window(ctx, run) -> None:
    counter = [0]
    errors = []

    def finish(item, in_window, in_slice):
        k, call, pending, phases, t = item
        try:
            if isinstance(pending, Exception):
                raise pending
            results = pending.resolve()
        except Exception as exc:
            errors.append(repr(exc))
            results = None
        t_done = time.perf_counter()

        def answer(i):
            if results is None or i >= len(results) or results[i] is None:
                return None
            return _answer(results[i])

        ctx.sample.offer(call, answer)
        run.records.append(Record(len(call), ctx.cells[k % len(ctx.pool)],
                                  t_done - t, results is not None, phases,
                                  in_window, in_slice))
        return t_done

    def pipeline(stop, in_slice=False):
        """Calls one deep until ``stop(queued, now, t0)``, then the last one
        drained; returns t0, the first queue's end, and the last resolve in
        the loop."""
        item = ctx.dispatch(counter[0])
        counter[0] += 1
        t0 = t_last = time.perf_counter()
        queued = 1
        while not stop(queued, t_last, t0):
            nxt = ctx.dispatch(counter[0])
            counter[0] += 1
            queued += 1
            t_last = finish(item, True, in_slice)
            item = nxt
        finish(item, False, in_slice)
        return t0, t_last

    seconds = ctx.seconds
    if not ctx.trace:
        t0, t1 = pipeline(lambda q, now, t0: now - t0 >= seconds)
        run.window_s = t1 - t0
    else:
        begin = time.perf_counter()
        pipeline(lambda q, now, t0: now - begin >= 0.4 * seconds)
        run.slice = trace.Slice()
        first = len(run.records)
        with trace.profiled(run.slice):
            pipeline(lambda q, now, t0: q >= int(ctx.traffic["trace_calls"]), True)
        sliced = run.records[first:]
        run.slice.units = len(sliced)
        run.slice.cells = sum(r.cells for r in sliced)
        pipeline(lambda q, now, t0: now - begin >= seconds)
        run.window_s = time.perf_counter() - begin
    run.answers = ctx.sample.answers()
    if errors:
        print(f"{len(errors)} calls failed; first: {errors[0]}", file=sys.stderr)
