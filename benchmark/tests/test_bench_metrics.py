"""The metric arithmetic on synthetic profiler events and phase records."""

import pytest

from benchmark.harness import core, peaks, readers, trace

MS = 1_000_000  # ns


def make_slice(units=2, cells=10 ** 9):
    ev = [("range", trace.SLICE_RANGE, 0, 100 * MS),
          ("range", "globalign.pack", 0, 30 * MS),
          ("range", "globalign.fill", 30 * MS, 40 * MS),
          ("range", "bench.request", 0, 100 * MS),
          ("kernel", "gotoh", 30 * MS, 50 * MS),
          ("kernel", "walk", 45 * MS, 60 * MS),  # overlaps gotoh
          ("memcpy", "Memcpy DtoH", 70 * MS, 80 * MS),
          ("kernel", "outside", 120 * MS, 130 * MS)]
    return trace.Slice(events=ev, units=units, cells=cells)


def test_union_and_gaps():
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.gaps([(5, 10), (20, 30)], 0, 40) == [(0, 5), (10, 20), (30, 40)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def test_idle_share_busy_and_window():
    s = make_slice()
    # busy: 30-60 (kernels) + 70-80 (copy) = 40 of 100 ms
    assert trace.busy_s(s) == pytest.approx(0.040)
    assert trace.window_s(s) == pytest.approx(0.100)
    assert trace.idle_share(s) == pytest.approx(60.0)
    assert readers.device_idle(core.Run(slice=s)) == pytest.approx(60.0)


def test_idle_by_innermost_range():
    idle = trace.idle_by_range(make_slice())
    # 0-30 pack (innermost, starts after bench.request at the same time: the
    # later start wins; equal starts go to the greater name) ...
    assert sum(idle.values()) == 60 * MS
    assert idle["globalign.pack"] == 30 * MS
    assert idle["bench.request"] == 30 * MS  # 60-70 and 80-100


def test_kernel_counts_and_roofline():
    s = make_slice(units=2, cells=10 ** 9)
    run = core.Run(slice=s, ceiling=peaks.ceiling_cells_per_s(132, 1980))
    assert readers.kernels_per_unit(run) == 1.0  # two kernels inside, two calls
    assert trace.kernel_seconds(s) == pytest.approx(0.035)
    want = 100 * 1e9 / (132 * 64 * 1980e6) / 0.035
    assert readers.dp_roofline(run) == pytest.approx(want)
    assert readers.dp_roofline(core.Run(slice=s)) is None  # no ceiling read
    assert readers.dp_roofline(core.Run()) is None


def test_ceiling_constants():
    assert peaks.ceiling_cells_per_s(132, 1980) == pytest.approx(16.727e12, rel=1e-3)


def test_percentiles_over_all_requests():
    values = [float(v) for v in range(1, 101)]
    assert readers.percentile(values, 50) == pytest.approx(50.5)
    assert readers.percentile(values, 95) == pytest.approx(95.05)
    recs = [core.Record(1, 1, v / 1e3, True) for v in values]
    recs.append(core.Record(1, 1, 5.0, True, in_window=False))
    run = core.Run(records=recs)
    assert readers.latencies_ms(run) == pytest.approx(values)


def test_batch_readers():
    recs = [core.Record(1024, 10 ** 9, 0.05, True,
                        {"validate": 0.002, "pack": 0.003, "fetch": 0.001}),
            core.Record(1024, 10 ** 9, 0.05, True,
                        {"validate": 0.004, "pack": 0.003, "fetch": 0.003}),
            core.Record(1024, 10 ** 9, 0.05, True, {"pack": 1.0}, in_slice=True),
            core.Record(1024, 10 ** 9, 0.05, False, {}, in_window=True),
            core.Record(1024, 5 * 10 ** 9, 0.05, True, {}, in_window=False)]
    run = core.Run(window_s=2.0, records=recs)
    assert readers.gcups(run) == pytest.approx(1.5)  # 3 Gcells ok in the window
    assert readers.host_ms(run) == pytest.approx(6.0)  # slice and empty phases out
    assert readers.fetch_ms(run) == pytest.approx(2.0)


def test_breakdown_lists_device_ops_and_idle():
    b = trace.breakdown(make_slice())
    assert b["device_ops"][0] == ["gotoh", pytest.approx(0.020)]
    assert {name for name, _ in b["device_ops"]} == {"gotoh", "walk", "Memcpy DtoH"}
    assert len(b["idle_gaps"]) <= 10


def test_every_metric_has_a_reader():
    spec = core.manifest()
    for metric in spec["end_to_end"] + spec["per_layer"]:
        module = core.load_module(core.BENCH / "metrics" / f"{metric['name']}.py")
        assert module.read(core.Run()) in (None, 0.0)
