"""A traceback ``align_pairs`` call whose pairs take the blocked route, under
the mpox cell's scheme (``benchmark/configs/mpox_blastn.json``: BLAST+'s
blastn, reward 2, penalty -3, gap open 5, gap extend 2), held against the
benchmark's plain reference (``benchmark/reference``).

On the card an mpox genome of 197 209 nt passes the 1536 MiB moves budget,
so each takes ``linear_tb.align_blocked`` on its own: a checkpoint pass,
then a replay fill and a walk a block.  Here the pairs are a few hundred
letters from the cell's own generator, the CPU's budget is cut below their
codes and the blocks to a few dozen rows, so every pair goes blocked in
several blocks through the same code.  This file imports no JAX.
"""

import json
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import traffic
from benchmark.reference import gotoh, scheme
from globalign_tpu_torch import align_pairs, batch
from globalign_tpu_torch.ops import fill_cuda, linear_tb

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "mpox_blastn.json").read_text())
MIX = json.loads((BENCH / "traffic" / "mpox_genomes_tb.json").read_text())
CARD_MEMORY = 85_000_000_000  # an H100 80GB HBM3's total memory, bytes


def _pairs(seed: int, length: int, count: int = 3):
    """``count`` pairs from the cell's generator and base shares at
    ``length`` letters, with edits enough that each holds indels."""
    spec = {**MIX, "pool_calls": 1, "pairs_per_call": count,
            "length": {"fixed": length},
            "edits": {"rates": {"substitution": 0.05, "indel": 0.03}}}
    (pairs,) = traffic.generate(spec, CONFIG["letters"], seed)
    assert any(len(a) != len(b) for a, b in pairs)
    return pairs


def _blocked(monkeypatch, rows: int):
    """Every pair past the CPU's moves budget, its blocks ``rows`` rows."""
    monkeypatch.setattr(batch, "DEFAULT_BATCH_MOVES_BUDGET", 4096)
    bounds = linear_tb.block_bounds
    monkeypatch.setattr(linear_tb, "block_bounds",
                        lambda m, n, *args: bounds(m, n, rows))


def _counters():
    return (batch.align_pairs.blocked_pairs, linear_tb.align_blocked.blocks,
            batch.align_pairs.segments)


def _answers(results):
    return [(r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
            for r in results]


@pytest.mark.parametrize("seed,length,rows", [
    (2 ** 31 + 5, 300, 64), (2 ** 31 + 6, 420, 37), (2 ** 31 + 7, 256, 255),
])
def test_blocked_pairs_match_the_reference(monkeypatch, seed, length, rows):
    """Costs, scores and the three lines equal the reference's; each pair
    goes blocked (``align_pairs.blocked_pairs``) in ceil(m / rows) blocks
    (``align_blocked.blocks``), and no traceback segment is dispatched."""
    pairs = _pairs(seed, length)
    _blocked(monkeypatch, rows)
    before = _counters()
    got = align_pairs(pairs, device="cpu", **CONFIG["scheme"])
    blocks = sum(-(-len(a) // rows) for a, _ in pairs)
    assert [a - b for a, b in zip(_counters(), before)] == [len(pairs), blocks, 0]
    want = gotoh.align(pairs, scheme.resolve(CONFIG["scheme"], CONFIG["letters"]),
                       traceback=True, device="cpu")
    assert _answers(got) == want


def test_a_replay_span_a_block(monkeypatch):
    """Under a profiler, a blocked pair opens one ``globalign.replay`` range
    a block, each inside the pair's ``globalign.replays`` and that inside
    its ``globalign.blocked``; the deferred call (``flush=False``) returns
    the same answers."""
    pairs = _pairs(2 ** 31 + 8, 200, count=2)
    _blocked(monkeypatch, 48)
    want = align_pairs(pairs, device="cpu", **CONFIG["scheme"])
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pending = align_pairs(pairs, device="cpu", flush=False, **CONFIG["scheme"])
    got = pending.resolve()
    assert _answers(got) == _answers(want)
    blocks = linear_tb.align_blocked.blocks - before[1]
    assert blocks == sum(-(-len(a) // 48) for a, _ in pairs)
    ranges = {}
    for e in prof.events():
        if e.name in ("globalign.blocked", "globalign.replays", "globalign.replay"):
            ranges.setdefault(e.name, []).append((e.time_range.start,
                                                  e.time_range.end))
    assert len(ranges["globalign.blocked"]) == len(pairs)
    assert len(ranges["globalign.replays"]) == len(pairs)
    assert len(ranges["globalign.replay"]) == blocks
    for name, outer in (("globalign.replay", "globalign.replays"),
                        ("globalign.replays", "globalign.blocked")):
        for s, e in ranges[name]:
            assert any(lo <= s and e <= hi for lo, hi in ranges[outer])


def test_pairs_under_the_budget_stay_batched(monkeypatch):
    """At the CPU's own budget the same pairs fill in one traceback segment:
    no pair is blocked, no replay block runs, and the answers are the
    blocked route's."""
    pairs = _pairs(2 ** 31 + 9, 300)
    before = _counters()
    batched = align_pairs(pairs, device="cpu", **CONFIG["scheme"])
    assert [a - b for a, b in zip(_counters(), before)] == [0, 0, 1]
    _blocked(monkeypatch, 64)
    assert _answers(align_pairs(pairs, device="cpu", **CONFIG["scheme"])) == \
        _answers(batched)


def test_a_genome_passes_the_card_budget_and_capacity():
    """An mpox genome's codes (197 210^2 bytes, 38.9 GB) pass both the card's
    moves budget and a segment's capacity on an 80 GB card."""
    m = MIX["length"]["fixed"]
    key = (batch.bucket_length(m), batch.bucket_length(m))
    assert fill_cuda.ragged_bytes(*key) > batch.DEVICE_WALK_MOVES_BUDGET
    assert fill_cuda.ragged_bytes(m, m) > 85_000_000_000 // 4
    assert np.isclose(fill_cuda.ragged_bytes(m, m), 3.89e10, rtol=1e-3)


@pytest.mark.parametrize("where", ["card", "cpu", "mesh"])
def test_the_block_budget_by_device(monkeypatch, where):
    """The blocked branch's block budget (``batch._block_budget``): on a card
    a quarter of its memory (``_card_memory``, patched to an H100's), the
    segments' capacity; on the CPU and with a mesh the 64 MiB default
    (``linear_tb.DEFAULT_BLOCK_MOVES_BYTES``).  On the CPU ``align_pairs``
    passes it to every blocked pair."""
    monkeypatch.setattr(batch, "_card_memory", lambda index: CARD_MEMORY)
    device = torch.device("cpu") if where == "cpu" else torch.device("cuda", 0)
    mesh = object() if where == "mesh" else None
    want = (CARD_MEMORY // 4 if where == "card"
            else linear_tb.DEFAULT_BLOCK_MOVES_BYTES)
    assert batch._block_budget(device, mesh) == want
    if where == "card":
        assert want == batch._segment_budget(device)
    if where != "cpu":
        return
    pairs = _pairs(2 ** 31 + 10, 200, count=2)
    monkeypatch.setattr(batch, "DEFAULT_BATCH_MOVES_BUDGET", 4096)
    real, seen = linear_tb.align_blocked, []

    def spy(*args, **kw):
        seen.append(kw["block_moves_bytes"])
        return real(*args, **kw)

    monkeypatch.setattr(linear_tb, "align_blocked", spy)
    align_pairs(pairs, device="cpu", **CONFIG["scheme"])
    assert seen == [want] * len(pairs)


def test_one_block_of_codes_at_a_time(monkeypatch):
    """``align_blocked`` holds at most one block's codes: when it asks
    ``batch_moves`` for the next block's, the codes of the block before
    (held by a weak reference) are gone."""
    pairs = _pairs(2 ** 31 + 11, 300, count=2)
    _blocked(monkeypatch, 40)
    real, held, alive = linear_tb.batch_moves, [], []

    def spy(*args, **kw):
        alive.extend(ref() is not None for ref in held)
        held.clear()
        final3, moves = real(*args, **kw)
        held.append(weakref.ref(moves))
        return final3, moves

    monkeypatch.setattr(linear_tb, "batch_moves", spy)
    align_pairs(pairs, device="cpu", **CONFIG["scheme"])
    blocks = sum(-(-len(a) // 40) for a, _ in pairs)
    assert len(alive) == blocks - 1 and not any(alive)
