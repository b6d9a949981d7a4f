"""A traceback ``align_pairs`` call of pairs past 1024 columns under BLAST+'s
blastn scheme (reward 2, penalty -3, gap open 5, gap extend 2), held
against the benchmark's plain reference (``benchmark/reference``), which
works its costs out again from the scheme's own values.

These pairs are past ``gotoh_batch_moves``' reach, so on the card they take
``gotoh_fill``'s ragged moves mode (the genomes' route); on the CPU the
plain version fills them through the same descriptors, segments, walk and
render.  This file imports no JAX.
"""

import numpy as np
import pytest

from benchmark.reference import gotoh, scheme
from globalign_tpu_torch import align_pairs, batch
from globalign_tpu_torch.ops import fill_cuda

BLASTN = dict(match_score=2, mismatch_score=-3, gap_open_score=-5,
              gap_extension_score=-2)


def _mutant(rng, seq: str, sub: float, indel: float) -> str:
    """``seq`` with each letter substituted with chance ``sub``, deleted or
    given an inserted letter before it with chance ``indel / 2`` each."""
    out = []
    for letter in seq:
        draw = rng.random()
        if draw < indel / 2:
            continue
        if draw < indel:
            out.append(str(rng.choice(list("ACGT"))))
        out.append(str(rng.choice([x for x in "ACGT" if x != letter]))
                   if rng.random() < sub else letter)
    return "".join(out)


def _pairs(seed: int, count: int):
    """``count`` seeded pairs, seq_1 of 1200-1600 letters and seq_2 a mutant
    of it, and one unrelated pair: 1100 columns and more each."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        one = "".join(rng.choice(list("ACGT"), int(rng.integers(1200, 1601))))
        pairs.append((one, _mutant(rng, one, 0.03, 0.02)))
    pairs.append(tuple("".join(rng.choice(list("ACGT"), int(rng.integers(1100, 1601))))
                       for _ in range(2)))
    assert all(len(b) >= 1100 for _, b in pairs)
    return pairs


def _reference(pairs):
    costing = scheme.resolve(BLASTN, "ACGT")
    return gotoh.align(pairs, costing, traceback=True, device="cpu")


def _answers(results):
    return [(r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
            for r in results]


@pytest.mark.parametrize("one_pair_a_segment", [False, True])
def test_wide_traceback_pairs_match_the_reference(monkeypatch, one_pair_a_segment):
    """Costs, scores and the three lines equal the reference's, in one
    segment (the CPU's default budget) or a segment a pair (the budget cut
    to the widest pair's padded codes, as a genome's 896 MB fill the card's
    1536 MiB); ``batch_moves_ragged.wide_pairs`` counts the pairs past 1024
    columns and ``align_pairs.segments`` the segments."""
    pairs = _pairs(7 + one_pair_a_segment, 3)
    if one_pair_a_segment:
        budget = max(fill_cuda.ragged_bytes(batch.bucket_length(len(a)),
                                            batch.bucket_length(len(b)))
                     for a, b in pairs)
        sizes = sorted(fill_cuda.ragged_bytes(len(a), len(b)) for a, b in pairs)
        assert sizes[0] + sizes[1] > budget  # no two pairs share a segment
        monkeypatch.setattr(batch, "DEFAULT_BATCH_MOVES_BUDGET", budget)
    else:  # a pair gotoh_batch_moves would take rides along, not counted
        pairs.append(("GATTACA" * 40, "GATACCA" * 60))
    before = (fill_cuda.batch_moves_ragged.wide_pairs, batch.align_pairs.segments)
    got = align_pairs(pairs, device="cpu", **BLASTN)
    after = (fill_cuda.batch_moves_ragged.wide_pairs, batch.align_pairs.segments)
    wide = sum(len(b) > 1024 for _, b in pairs)
    assert (after[0] - before[0], after[1] - before[1]) == (
        wide, len(pairs) if one_pair_a_segment else 1)
    assert _answers(got) == _reference(pairs)


def test_scores_follow_the_blastn_costs():
    """The scheme in globalign's cost space (b = 2): match 0, mismatch 5, a
    letter against a gap 3, gap open 5; score = n + m - cost."""
    costing = scheme.resolve(BLASTN, "ACGT")
    assert costing.gap_open == 5 and costing.max_score == 2
    assert set(costing.cost[:4, :4].ravel().tolist()) == {0, 5}
    assert (costing.cost[4, :4] == 3).all() and (costing.cost[:4, 4] == 3).all()
    (got,) = align_pairs([("ACGTACGT", "ACGAACG")], device="cpu", **BLASTN)
    assert got.cost == 5 + 3 + 5  # one mismatch, a gap of one letter
    assert got.score == 8 + 7 - got.cost == 2 * 6 - 3 - (5 + 2)
