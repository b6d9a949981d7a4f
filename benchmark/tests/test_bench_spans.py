"""The readers of the program's spans (``host_ms.pair``, ``fetch_ms.pair``,
``wide_ms.batch``) on synthetic profiler events, and a traced CPU run of
the single-pair cell that reports them."""

import time

import pytest

from benchmark.harness import core, trace

from .conftest import tiny_traffic

MS = 1_000_000  # ns


def reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py").read


def make_run(ranges, units=2):
    events = [("range", trace.SLICE_RANGE, 0, 100 * MS)]
    events += [("range", name, s * MS, e * MS) for name, s, e in ranges]
    events.append(("kernel", "gotoh", 10 * MS, 60 * MS))
    return core.Run(slice=trace.Slice(events=events, units=units))


# Two requests: the second's validate holds scheme (nested), its fetch
# repeats (two ranges that overlap), and one range runs past the slice.
PAIR = [("bench.request", 0, 40), ("globalign.validate", 0, 5),
        ("globalign.aligner", 5, 8), ("globalign.replays", 8, 15),
        ("globalign.fetch", 15, 30), ("globalign.traceback", 30, 34),
        ("bench.request", 40, 100), ("globalign.validate", 40, 50),
        ("globalign.scheme", 42, 48), ("globalign.fetch", 50, 70),
        ("globalign.fetch", 60, 75), ("globalign.results", 95, 110)]


def test_pair_readers_count_the_union_once():
    run = make_run(PAIR)
    # globalign.*: 0-34 and 40-75 and 95-100 = 74 ms; fetch 15-30, 50-75 = 40
    assert reader("fetch_ms.pair")(run) == pytest.approx(40 / 2)
    assert reader("host_ms.pair")(run) == pytest.approx((74 - 40) / 2)


def test_host_ms_pair_leaves_the_fetch_out():
    with_fetch = make_run([("globalign.encode", 0, 10), ("globalign.fetch", 10, 30)])
    without = make_run([("globalign.encode", 0, 10)])
    assert reader("host_ms.pair")(with_fetch) == reader("host_ms.pair")(without) == 5
    assert reader("fetch_ms.pair")(without) is None


def test_wide_ms_batch_counts_nested_and_repeated_ranges_once():
    run = make_run([("globalign.fill", 0, 50), ("globalign.fill.batch", 0, 10),
                    ("globalign.fill.wide", 10, 30), ("globalign.fill.wide", 20, 40),
                    ("globalign.fill", 60, 80), ("globalign.fill.wide", 65, 70)])
    assert reader("wide_ms.batch")(run) == pytest.approx((30 + 5) / 2)


@pytest.mark.parametrize("name", ["host_ms.pair", "fetch_ms.pair", "wide_ms.batch"])
@pytest.mark.parametrize("ranges", [
    [], [("bench.request", 0, 50), ("bench.slice.other", 10, 20)],
    [("globalign.fetch", 200, 300), ("globalign.fill.wide", 100, 120)],  # past it
])
def test_no_such_range_gives_none(name, ranges):
    assert reader(name)(make_run(ranges)) is None
    assert reader(name)(core.Run()) is None


def test_traced_cpu_run_of_the_pair_cell_reports_the_span_metrics():
    cell = "dna.pair_align"
    code, result = core.run_cell(cell, 2 ** 31 + 41, 0.3, True,
                                 t_start=time.perf_counter(), device="cpu",
                                 traffic=tiny_traffic(cell))
    assert code == 0 and result["correct"]
    metrics = result["metrics"]
    assert {"host_ms.pair", "fetch_ms.pair"} <= set(metrics)
    assert metrics["host_ms.pair"]["value"] > 0 and metrics["fetch_ms.pair"]["value"] > 0
    # no device on the CPU: the whole slice is idle, split by the spans
    idle = dict(result["breakdown"]["idle_gaps"])
    assert {"globalign.validate", "globalign.fetch"} <= set(idle)
