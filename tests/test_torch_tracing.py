"""The port's host spans (``globalign_tpu_torch.utils.spans``), on the CPU.

A span opens its ``record_function`` range only under a running profiler,
fills ``phase_seconds`` only when given one, and touches nothing of CUDA.
Under ``torch.profiler`` a single-pair request shows its spans one after
another inside the call, and ``align_pairs``' ``phase_seconds`` keeps
exactly its documented phases.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from globalign_tpu_torch import (
    GotohAligner,
    align_pairs,
    find_global_alignment,
    resolve_scheme,
)
from globalign_tpu_torch import batch as batch_mod
from globalign_tpu_torch.utils import spans
from globalign_tpu_torch.utils.spans import span

CALL = "test.call"


def _ranges(prof):
    """(name, start, end) of the profile's ``globalign.*`` ranges and the
    test's own, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith((spans.PREFIX, CALL))]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _profiled(fn):
    """``fn()`` inside a ``test.call`` range under a CPU profiler: its
    result, the ranges, and the call's (start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            out = fn()
    ranges = _ranges(prof)
    call = next((s, e) for name, s, e in ranges if name == CALL)
    return out, [r for r in ranges if r[0] != CALL], call


def _top_level(ranges):
    """The ranges no other range holds."""
    return [r for r in ranges
            if not any(o is not r and o[1] <= r[1] and r[2] <= o[2]
                       and (o[1], -o[2]) < (r[1], -r[2]) for o in ranges)]


def _raise(*args, **kwargs):
    raise AssertionError("called")


@pytest.mark.parametrize("with_dict", [False, True])
def test_span_without_a_profiler_opens_no_range(monkeypatch, with_dict):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    phases = {} if with_dict else None
    for _ in range(2):
        with span("pack", phases):
            sum(range(1000))
    if with_dict:
        assert list(phases) == ["pack"] and phases["pack"] > 0


@pytest.mark.parametrize("with_dict", [False, True])
def test_span_under_a_profiler_emits_its_range(with_dict):
    phases = {} if with_dict else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("fill", phases):
            with span("fill.wide"):
                pass
    names = [name for name, _, _ in _ranges(prof)]
    assert names == ["globalign.fill", "globalign.fill.wide"]
    assert phases == ({"fill": phases["fill"]} if with_dict else None)


@pytest.mark.parametrize("profiled", [False, True])
def test_span_touches_nothing_of_cuda(monkeypatch, profiled):
    """No event, no synchronisation, no copy: a span runs with every CUDA
    entry it could reach broken."""
    for name in ("synchronize", "Event", "current_stream", "is_available"):
        monkeypatch.setattr(torch.cuda, name, _raise)
    monkeypatch.setattr(torch.Tensor, "cuda", _raise)
    phases = {}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            with span("fetch", phases):
                pass
    else:
        with span("fetch", phases):
            pass
    assert list(phases) == ["fetch"]


def test_span_adds_up_repeated_phases():
    phases = {"fill": 1.0}
    with span("fill", phases):
        pass
    with span("fill", phases):
        pass
    assert list(phases) == ["fill"] and phases["fill"] > 1.0


SCHEMES = [
    ("GATTACAGATTACA", "GCATGCTAGCA", {}),
    ("HEAGAWGHEEKLLV", "PAWHEAEWQRK", {"scoring_mat_name": "BLOSUM62"}),
]
FULL_MATRIX = ["validate", "aligner", "encode", "fill", "fetch", "traceback",
               "results"]


@pytest.mark.parametrize("seq_1,seq_2,scheme", SCHEMES)
def test_single_pair_request_spans_in_order(seq_1, seq_2, scheme):
    want = find_global_alignment(seq_1=seq_1, seq_2=seq_2, device="cpu", **scheme)
    got, ranges, (lo, hi) = _profiled(lambda: find_global_alignment(
        seq_1=seq_1, seq_2=seq_2, device="cpu", **scheme))
    assert got == want
    top = _top_level(ranges)
    assert [name for name, _, _ in top] == [spans.PREFIX + s for s in FULL_MATRIX]
    for (_, _, end), (_, start, _) in zip(top, top[1:]):
        assert end <= start  # one after another, none overlapping
    assert all(lo <= s and e <= hi for _, s, e in ranges)
    # the scheme's tables inside validate, nothing else nested
    nested = [r for r in ranges if r not in top]
    assert [name for name, _, _ in nested] == ["globalign.scheme"]
    validate = top[0]
    assert validate[1] <= nested[0][1] and nested[0][2] <= validate[2]


def test_blocked_align_spans():
    seq_1, seq_2 = "GATTACAGATTACAGATTACA" * 3, "GCATGCTAGCAGCATGCT" * 3
    scheme = resolve_scheme(seq_1, seq_2)
    aligner = GotohAligner(scheme, moves_budget_bytes=256, device="cpu")
    want = GotohAligner(scheme, device="cpu").align(seq_1, seq_2)
    got, ranges, _ = _profiled(lambda: aligner.align(seq_1, seq_2))
    assert got == want
    assert [name for name, _, _ in _top_level(ranges)] == [
        spans.PREFIX + s
        for s in ("encode", "checkpoints", "replays", "fetch", "traceback")
    ]


COST_ONLY = {"validate", "scheme", "bucket", "pack", "fill", "fetch", "results"}
TRACEBACK = COST_ONLY | {"render", "traceback"}


@pytest.mark.parametrize("case,want", [
    ("cost_only", COST_ONLY),
    ("traceback", TRACEBACK),
    ("blocked_pair", TRACEBACK | {"blocked"}),
])
@pytest.mark.parametrize("profiled", [False, True])
def test_phase_seconds_keys_are_the_documented_phases(monkeypatch, case, want,
                                                      profiled):
    rng = np.random.default_rng(17)
    pairs = [("".join(rng.choice(list("ACGT"), m)),
              "".join(rng.choice(list("ACGT"), n)))
             for m, n in ((5, 9), (30, 28), (31, 12), (60, 50))]
    if case == "blocked_pair":  # the 64 x 64 bucket's codes pass the budget
        monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", 2000)
    phases = {}

    def call():
        return align_pairs(pairs, with_traceback=case != "cost_only",
                           device="cpu", phase_seconds=phases)

    if profiled:
        _, ranges, _ = _profiled(call)
        names = {name[len(spans.PREFIX):] for name, _, _ in ranges}
        assert want <= names
        if case == "blocked_pair":  # align_blocked's own, inside blocked
            assert {"checkpoints", "replays"} <= names
    else:
        call()
    assert set(phases) == want
    assert not any(key.startswith("fill.") for key in phases)
    assert all(v >= 0 for v in phases.values())
