"""Random test-sequence generation (tooling parity with the reference).

Capability parity with src/globalign/start.py:691-867: ``draw_random_seq``
draws a seeded random-length sequence, and ``draw_two_random_seqs`` derives a
second sequence from the first by a divergence-controlled number of
insert/delete/substitute edits whose positions are end-biased (probability
``(1 - divergence) ** (1/k)`` of editing at an end), so low divergence tends
to preserve the first sequence as a subsequence.

The seeded golden outputs in the reference test suite
(tests/start_test.py:68-115 — e.g. seed 19 over ACTG with lengths 7..10 gives
"GTTCGCA") are reproduced exactly because both implementations drive the same
stdlib ``random`` primitives in the same order.
"""

from __future__ import annotations

import math
import random


def draw_random_seq(
    alphabet: list[str],
    min_len: int,
    max_len: int,
    seed: int | None = None,
) -> str:
    """Seeded random sequence of length uniform in [min_len, max_len].

    Raises:
        ValueError: if min_len < 0 or min_len > max_len.
        IndexError: if alphabet is empty.
        TypeError: if alphabet is not a sequence of strings.
    """
    random.seed(seed)
    if min_len < 0:
        print("min_len must be a non-negative integer.")
        raise ValueError
    try:
        seq_len = random.randint(a=min_len, b=max_len)
    except ValueError:
        print(
            "min_len and max_len must be non-negative integers with "
            "max_len >= min_len."
        )
        raise
    try:
        draws = random.choices(population=alphabet, k=seq_len)
    except (IndexError, TypeError):
        print("alphabet must be a non-empty list of strings")
        raise
    return "".join(draws)


def _end_biased_index(prob_ends: float, length: int, for_insert: bool) -> int:
    """Pick an edit position: ends with probability ``prob_ends``, else middle."""
    r = random.random()
    if r < prob_ends / 2:
        return 0
    if for_insert:
        if r < prob_ends:
            return length
        lo = min(1, length - 1)
        hi = max(1, length - 1)
    else:
        if r < prob_ends:
            return length - 1
        lo = min(1, length - 1)
        hi = max(lo, length - 2)
    return random.randint(a=lo, b=hi)


def draw_two_random_seqs(
    alphabet: list,
    min_len_seq_1: int,
    max_len_seq_1: int,
    min_len_seq_2: int,
    max_len_seq_2: int,
    divergence: float,
    seed_1: int | None = None,
    seed_2: int | None = None,
) -> tuple[str, str]:
    """Draw a random pair where seq_2 is a divergence-controlled edit of seq_1.

    Args:
        divergence: in [0, 1]; higher makes the sequences more different.
            ``ceil(divergence * len(seq_2) / 3)`` extra edits of each kind
            (insert/delete/substitute) are applied on top of the length
            adjustment (reference start.py:765-769).
    """
    seq_1 = draw_random_seq(
        alphabet=alphabet, min_len=min_len_seq_1, max_len=max_len_seq_1, seed=seed_1
    )
    seq_2_list = list(seq_1)

    random.seed(seed_2)
    len_seq_2 = random.randint(a=min_len_seq_2, b=max_len_seq_2)
    len_delta = len_seq_2 - len(seq_1)

    extra = math.ceil(divergence * len_seq_2 / 3)
    num_insertions = max(0, len_delta) + extra
    num_deletions = max(0, -len_delta) + extra
    num_substitutions = extra

    if num_insertions > 0:
        letters_to_insert = draw_random_seq(
            alphabet=alphabet,
            min_len=num_insertions,
            max_len=num_insertions,
            seed=seed_2,
        )
        p_ins = (1 - divergence) ** (1 / num_insertions)
        for t in range(num_insertions):
            pos = _end_biased_index(p_ins, len(seq_2_list), for_insert=True)
            seq_2_list.insert(pos, letters_to_insert[t])

    if num_deletions > 0:
        p_del = (1 - divergence) ** (1 / num_deletions)
        for _ in range(num_deletions):
            pos = _end_biased_index(p_del, len(seq_2_list), for_insert=False)
            seq_2_list.pop(pos)

    if num_substitutions > 0:
        letters_to_sub = draw_random_seq(
            alphabet=alphabet,
            min_len=num_substitutions,
            max_len=num_substitutions,
        )
        p_sub = (1 - divergence) ** (1 / num_substitutions)
        for t in range(num_substitutions):
            pos = _end_biased_index(p_sub, len(seq_2_list), for_insert=False)
            seq_2_list[pos] = letters_to_sub[t]

    return seq_1, "".join(seq_2_list)
