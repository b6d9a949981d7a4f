"""List-of-lists adapters for the reference's DP-internal API.

The reference exposes its interpreted fill's internals as public module
symbols (reference globaligner.py:317-821), and its own test suite calls
``dp_array_forward`` on a hand-seeded array
(reference tests/globaligner_test.py:4-37).  The port has no
list-of-lists DP array — its fills are dense int32 tensors — so these
adapters re-implement the same *semantics* on the reference's data shape
(nested ``dict`` costing matrices, ``(M, Ix, Iy)`` tuples) for drop-in
consumers.  They are interpreted compatibility views, not a compute
path, and never touch the card: batch or long-sequence work belongs on
:func:`globalign_tpu_torch.align_pairs` /
:func:`globalign_tpu_torch.find_global_alignment`.

A copy of ``globalign/dp_compat.py`` that this package keeps as its own.

Deterministic divergences from the reference, by design:

* ``dp_array_backward`` breaks cost ties in the fixed engine order
  (M, then Ix, then Iy) instead of unseeded ``random.choice``
  (reference globaligner.py:595-685); the returned alignment is always
  one of the reference's optimal set and prices to the same cost.
* The level-2 re-entry cost uses the correct
  ``costing_mat[seq_1[i-1]]["-"]`` lookup, not the reference's
  transposed ``costing_mat["-"][seq_2[j-1]]`` quirk
  (reference globaligner.py:500-505; SURVEY.md "behavioral quirks") —
  identical for symmetric/uniform schemes, correct for odd-``b``
  transformed matrices.
"""

from __future__ import annotations

GAP = "-"


def make_dp_array(seq_1, seq_2, costing_mat, max_cost, gap_open_cost):
    """``(len(seq_1)+1) x (len(seq_2)+1)`` list-of-lists with the
    reference's boundary: ``(0,0,0)`` origin, level-1 gap run along row
    0, level-2 gap run along column 0, ``big_num`` sentinels elsewhere
    (reference globaligner.py:756-821)."""
    m, n = len(seq_1), len(seq_2)
    big_num = (max_cost + 1) * max(m, n)
    dp = [[None] * (n + 1) for _ in range(m + 1)]
    dp[0][0] = (0, 0, 0)
    run = gap_open_cost
    for j in range(1, n + 1):
        run += costing_mat[GAP][seq_2[j - 1]]
        dp[0][j] = (big_num, run, big_num)
    run = gap_open_cost
    for i in range(1, m + 1):
        run += costing_mat[seq_1[i - 1]][GAP]
        dp[i][0] = (big_num, big_num, run)
    return dp


def get_next_best_costs(
    dp_array, i, j, seq_1, seq_2, costing_mat, gap_open_cost
):
    """One Gotoh cell in cost space: ``(M, Ix, Iy)`` at ``(i, j)`` from
    the three predecessor cells, gap-open charged as a level-transition
    penalty (reference globaligner.py:317-363)."""
    diag, left, up = dp_array[i - 1][j - 1], dp_array[i][j - 1], dp_array[i - 1][j]
    a, b = seq_1[i - 1], seq_2[j - 1]
    go = gap_open_cost
    return (
        min(diag) + costing_mat[a][b],
        min(left[0] + go, left[1], left[2] + go) + costing_mat[GAP][b],
        min(up[0] + go, up[1] + go, up[2]) + costing_mat[a][GAP],
    )


def dp_array_forward(dp_array, seq_1, seq_2, costing_mat, gap_open_cost):
    """In-place row-major fill of a (possibly hand-seeded) DP array
    (reference globaligner.py:366-392)."""
    for i in range(1, len(seq_1) + 1):
        row = dp_array[i]
        for j in range(1, len(seq_2) + 1):
            row[j] = get_next_best_costs(
                dp_array, i, j, seq_1, seq_2, costing_mat, gap_open_cost
            )
    return None


def take_match(seq_1, seq_2, seq_1_index, seq_2_index,
               seq_1_aligned, middle_part, seq_2_aligned):
    """Append a diagonal match move to the three lists, in place
    (reference globaligner.py:688-702)."""
    seq_1_aligned.append(seq_1[seq_1_index])
    middle_part.append("|")
    seq_2_aligned.append(seq_2[seq_2_index])
    return None


def take_mismatch(seq_1, seq_2, seq_1_index, seq_2_index,
                  seq_1_aligned, middle_part, seq_2_aligned):
    """Append a diagonal mismatch move (reference globaligner.py:705-719)."""
    seq_1_aligned.append(seq_1[seq_1_index])
    middle_part.append("*")
    seq_2_aligned.append(seq_2[seq_2_index])
    return None


def take_gap_in_seq_1(seq_1, seq_2, seq_1_index, seq_2_index,
                      seq_1_aligned, middle_part, seq_2_aligned):
    """Append a horizontal move: gap in seq_1, consume seq_2
    (reference globaligner.py:722-736)."""
    seq_1_aligned.append(GAP)
    middle_part.append(" ")
    seq_2_aligned.append(seq_2[seq_2_index])
    return None


def take_gap_in_seq_2(seq_1, seq_2, seq_1_index, seq_2_index,
                      seq_1_aligned, middle_part, seq_2_aligned):
    """Append a vertical move: gap in seq_2, consume seq_1
    (reference globaligner.py:739-753)."""
    seq_1_aligned.append(seq_1[seq_1_index])
    middle_part.append(" ")
    seq_2_aligned.append(GAP)
    return None


def dp_array_backward(dp_array, seq_1, seq_2, costing_mat, gap_open_cost):
    """Deterministic traceback over a filled DP array.

    Returns ``(seq_1_aligned, middle_part, seq_2_aligned, cost)`` —
    the reference's contract (globaligner.py:395-592) with its random
    tie-breaking replaced by the engine's fixed (M, Ix, Iy) preference
    order.  The emitted alignment always prices to ``cost``."""
    m, n = len(seq_1), len(seq_2)
    out_1: list = []
    mid: list = []
    out_2: list = []
    i, j = m, n
    cell = dp_array[i][j]
    cost = min(cell)
    level = min(range(3), key=lambda k: (cell[k], k))
    go = gap_open_cost
    while i > 0 and j > 0:
        a, b = seq_1[i - 1], seq_2[j - 1]
        if level == 0:
            prev = dp_array[i - 1][j - 1]
            want = dp_array[i][j][0] - costing_mat[a][b]
            cands = (prev[0], prev[1], prev[2])
            take = take_match if a == b else take_mismatch
            take(seq_1, seq_2, i - 1, j - 1, out_1, mid, out_2)
            i, j = i - 1, j - 1
        elif level == 1:
            prev = dp_array[i][j - 1]
            want = dp_array[i][j][1] - costing_mat[GAP][b]
            cands = (prev[0] + go, prev[1], prev[2] + go)
            take_gap_in_seq_1(seq_1, seq_2, i - 1, j - 1, out_1, mid, out_2)
            j -= 1
        else:
            prev = dp_array[i - 1][j]
            want = dp_array[i][j][2] - costing_mat[a][GAP]
            cands = (prev[0] + go, prev[1] + go, prev[2])
            take_gap_in_seq_2(seq_1, seq_2, i - 1, j - 1, out_1, mid, out_2)
            i -= 1
        level = next(k for k in range(3) if cands[k] == want)
    while j > 0:  # row 0: only horizontal moves remain
        take_gap_in_seq_1(seq_1, seq_2, i - 1, j - 1, out_1, mid, out_2)
        j -= 1
    while i > 0:  # column 0: only vertical moves remain
        take_gap_in_seq_2(seq_1, seq_2, i - 1, j - 1, out_1, mid, out_2)
        i -= 1
    out_1.reverse()
    mid.reverse()
    out_2.reverse()
    return "".join(out_1), "".join(mid), "".join(out_2), cost
