"""Drive ``find_global_alignment`` one request at a time, as a user who
aligns pair after pair does: each request waits for its answer (strings,
cost and score) before the next is sent.  The pool's pairs are taken in
turn; the program keeps nothing between requests.

The window issues requests until its length has passed, and the latency of
each is the host clock around its call.  A traced run profiles
``trace_calls`` requests in the middle of the window, each inside a
``bench.request`` range.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness import trace
from benchmark.harness.core import Record


def warm_up(ctx) -> None:
    options = dict(ctx.config["scheme"], device=ctx.device,
                   max_seq_len_prod=int(ctx.traffic["max_seq_len_prod"]))

    def request(seq_1, seq_2):
        return ctx.port.find_global_alignment(seq_1=seq_1, seq_2=seq_2, **options)

    ctx.request = request
    for k in range(min(int(ctx.traffic["warmup_calls"]), len(ctx.pool))):
        request(*ctx.pool[k][0])
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def window(ctx, run) -> None:
    errors = []
    counter = [0]

    def serve(stop, in_slice=False):
        t0 = t_last = time.perf_counter()
        served = 0
        while not stop(served, t_last):
            pair = ctx.pool[counter[0] % len(ctx.pool)][0]
            counter[0] += 1
            served += 1
            t = time.perf_counter()
            try:
                if in_slice:
                    with torch.profiler.record_function("bench.request"):
                        r = ctx.request(*pair)
                else:
                    r = ctx.request(*pair)
                got = (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
            except Exception as exc:
                errors.append(repr(exc))
                got = None
            t_last = time.perf_counter()
            run.records.append(Record(1, len(pair[0]) * len(pair[1]), t_last - t,
                                      got is not None, None, True, in_slice))
            ctx.sample.offer([pair], lambda i: got)
        return t0, t_last

    seconds = ctx.seconds
    begin = time.perf_counter()
    if not ctx.trace:
        t0, t1 = serve(lambda served, now: now - begin >= seconds)
        run.window_s = t1 - t0
    else:
        serve(lambda served, now: now - begin >= 0.4 * seconds)
        run.slice = trace.Slice()
        first = len(run.records)
        with trace.profiled(run.slice):
            serve(lambda served, now: served >= int(ctx.traffic["trace_calls"]), True)
        sliced = run.records[first:]
        run.slice.units = len(sliced)
        run.slice.cells = sum(r.cells for r in sliced)
        serve(lambda served, now: now - begin >= seconds)
        run.window_s = time.perf_counter() - begin
    run.answers = ctx.sample.answers()
    if errors:
        print(f"{len(errors)} requests failed; first: {errors[0]}", file=sys.stderr)
