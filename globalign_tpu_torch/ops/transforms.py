"""Score <-> cost transforms (the reference's distinguishing feature).

Implements the Akulov / Groot-Koerkamp alignment-scores transform
(https://curiouscoding.nl/posts/alignment-scores-transform/) that converts any
similarity (scoring) matrix into a valid distance (costing) matrix and back,
and the matching final-value transforms.

Semantics parity with the reference:
  * matrix transforms        — src/globalign/start.py:500-612
  * final value transforms   — src/globalign/conclude.py:154-202

With ``b`` the max score, ``delta_d = floor(b/2)`` and ``delta_i = ceil(b/2)``:
  * deletion entries (gap row, i.e. ("-", x) — horizontal DP steps consuming a
    seq_2 letter) map ``s -> -s + delta_d``
  * insertion entries (gap column, (x, "-") — vertical steps consuming a seq_1
    letter) map ``s -> -s + delta_i``
  * match/mismatch entries (and the gap/gap diagonal cell) map
    ``s -> -s + delta_d + delta_i``

and the final alignment values satisfy ``score + cost == n*delta_d + m*delta_i``
for sequences of length ``m`` (seq_1) and ``n`` (seq_2).
"""

from __future__ import annotations

import numpy as np

from ..utils.matrices import SubstitutionMatrix


def split_deltas(max_score: int, delta_d=None, delta_i=None) -> tuple[int, int]:
    """(delta_d, delta_i) = (floor(b/2), ceil(b/2)) unless explicitly given."""
    b = max_score
    if delta_d is None:
        delta_d = b // 2 if isinstance(b, int) else int(np.floor(b / 2))
    if delta_i is None:
        delta_i = -((-b) // 2) if isinstance(b, int) else int(np.ceil(b / 2))
    return delta_d, delta_i


def _transform(values: np.ndarray, gap: int, delta_d: int, delta_i: int) -> np.ndarray:
    """Shared core: out = -v + (delta per entry class)."""
    a = values.shape[0]
    add = np.full((a, a), delta_d + delta_i, dtype=np.int64)
    add[gap, :] = delta_d  # deletions: gap row, horizontal steps
    add[:, gap] = delta_i  # insertions: gap column, vertical steps
    add[gap, gap] = delta_d + delta_i  # gap/gap diagonal = match/mismatch class
    return (-values.astype(np.int64) + add).astype(np.int32)


def scoring_mat_to_costing_mat(
    scoring_mat: SubstitutionMatrix,
    max_score: int,
    delta_d=None,
    delta_i=None,
) -> SubstitutionMatrix:
    """Similarity matrix -> valid distance matrix (reference start.py:500-557)."""
    delta_d, delta_i = split_deltas(max_score, delta_d, delta_i)
    gap = scoring_mat.alphabet.gap_id
    return SubstitutionMatrix(
        scoring_mat.alphabet, _transform(scoring_mat.values, gap, delta_d, delta_i)
    )


def costing_mat_to_scoring_mat(
    costing_mat: SubstitutionMatrix,
    max_score: int,
    delta_d=None,
    delta_i=None,
) -> SubstitutionMatrix:
    """Distance matrix -> similarity matrix (reference start.py:559-612).

    This is the exact inverse of :func:`scoring_mat_to_costing_mat` for the
    same deltas (both are involutions of the form ``x -> delta - x``).
    """
    # The forward and inverse maps are numerically identical: delta - x.
    delta_d, delta_i = split_deltas(max_score, delta_d, delta_i)
    gap = costing_mat.alphabet.gap_id
    return SubstitutionMatrix(
        costing_mat.alphabet, _transform(costing_mat.values, gap, delta_d, delta_i)
    )


def final_cost_to_score(
    cost: int, m: int, n: int, max_score: int, delta_d=None, delta_i=None
) -> int:
    """score = n*delta_d + m*delta_i - cost (reference conclude.py:154-177).

    Args:
        m: length of seq_1 (vertical axis — insertions carry ``delta_i``).
        n: length of seq_2 (horizontal axis — deletions carry ``delta_d``).
    """
    delta_d, delta_i = split_deltas(max_score, delta_d, delta_i)
    return n * delta_d + m * delta_i - cost


def final_score_to_cost(
    score: int, m: int, n: int, max_score: int, delta_d=None, delta_i=None
) -> int:
    """cost = n*delta_d + m*delta_i - score (reference conclude.py:179-202)."""
    delta_d, delta_i = split_deltas(max_score, delta_d, delta_i)
    return n * delta_d + m * delta_i - score
