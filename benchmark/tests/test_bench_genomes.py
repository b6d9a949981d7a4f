"""The genome cell (``sars2.batch_tb``) run whole on the CPU at 1200 nt, past
``gotoh_batch_moves``' 1024 columns, so that the traceback's wide route
runs: a sound program reads correct and one letter of one line altered
reads not correct."""

import time

import pytest

from benchmark.harness import core, judge

from .test_bench_run import Broken

CELL = "sars2.batch_tb"


def traffic():
    """The cell's traffic cut to one call of 4 pairs of 1200 nt, every
    answer kept."""
    _, _, mix, _ = core.cell_parts(CELL)
    return {**mix, "pairs_per_call": 4, "pool_calls": 1, "length": {"fixed": 1200},
            "warmup_calls": 1, "trace_calls": 1, "sample": {"reservoir": 4096}}


@pytest.mark.parametrize("fault", [None, "letter"])
def test_genome_cell_judges_lines(fault):
    code, result = core.run_cell(CELL, 2 ** 31 + 41, 0.2, False,
                                 t_start=time.perf_counter(), device="cpu",
                                 port=None if fault is None else Broken(fault),
                                 traffic=traffic())
    assert code == 0
    assert result["checks"]["compared"]["value"] == result["attempted"] >= 8
    if fault is None:
        assert result["correct"] and result["failed"] == 0
        assert set(result["metrics"]) == {"batch_gcups", "setup_s"}
    else:
        assert not result["correct"] and not judge.passed(result["checks"])
        assert result["checks"]["line_mismatch"]["value"] > 0
