"""Deterministic traceback from packed move codes.

Replaces the reference's rank-and-dispatch traceback
(src/globalign/globaligner.py:395-685): instead of re-ranking adjusted costs
at every step (and breaking ties with unseeded ``random.choice``,
globaligner.py:598-672), the fill records each cell's argmin provenance as
2-bit codes per DP level, and the traceback is a simple predecessor walk over
those codes.  This implements the *correct* level-transition bookkeeping —
including the vertical-step cost lookup ``cost(a_i, '-')`` that the reference
gets subtly wrong at globaligner.py:500-505 (documented in SURVEY.md §2) —
and guarantees the traced path's cost equals the fill's optimal cost (see
tests/test_oracle.py).

Move emission parity (globaligner.py:688-753): ``|`` match, ``*`` mismatch,
``' '`` gap in the middle line; ``-`` is the gap character in sequence lines.

The walk is O(m+n) scalar steps over a host-resident uint8 array.  The
port's ``align`` does not call it: it walks the codes where they were
filled (``ops.linear_tb.walk_block``, the walk kernel on a card) and
fetches only the op tape.  This host walk is the copy of the JAX package's
(pinned to it by ``tests/test_torch_host.py``) and the independent oracle
that ``tests/test_torch_cuda.py`` holds the card's walk against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEVEL_M, LEVEL_IX, LEVEL_IY = 0, 1, 2

MATCH_GLYPH = "|"
MISMATCH_GLYPH = "*"
GAP_GLYPH = " "
GAP_CHAR = "-"


class Traceback(NamedTuple):
    seq_1_aligned: str
    middle_part: str
    seq_2_aligned: str
    cost: int


def traceback_moves(
    moves: np.ndarray,
    seq_1: str,
    seq_2: str,
    final3: np.ndarray,
) -> Traceback:
    """Walk packed move codes from (m, n) back to (0, 0).

    Args:
        moves: (m+1, n+1) uint8 packed codes, ``moves[i, j]`` the code of
            cell (i, j) — bits 0-1 level-M predecessor, 2-3 level-Ix, 4-5
            level-Iy (values 0=M, 1=Ix, 2=Iy) — the row-major layout of
            ``ops.fill_rows`` / ``ops.fill_cuda``.
        final3: (3,) costs (M, Ix, Iy) at (m, n); the walk starts at the
            argmin level (ties prefer M, then Ix — the engine's documented
            deterministic tie order).
    """
    moves = np.asarray(moves)
    final3 = np.asarray(final3)
    m, n = len(seq_1), len(seq_2)

    out_1: list[str] = []
    mid: list[str] = []
    out_2: list[str] = []

    i, j = m, n
    level = int(final3.argmin())
    cost = int(final3.min())

    while i > 0 or j > 0:
        if i == 0:
            # Top row: only horizontal moves remain (gap in seq_1), matching
            # the reference's row-0 shortcut (globaligner.py:542-561).
            out_1.append(GAP_CHAR)
            mid.append(GAP_GLYPH)
            out_2.append(seq_2[j - 1])
            j -= 1
            continue
        if j == 0:
            # Left column: only vertical moves remain (gap in seq_2)
            # (globaligner.py:562-581).
            out_1.append(seq_1[i - 1])
            mid.append(GAP_GLYPH)
            out_2.append(GAP_CHAR)
            i -= 1
            continue

        code = int(moves[i, j])
        if level == LEVEL_M:
            a, b = seq_1[i - 1], seq_2[j - 1]
            out_1.append(a)
            mid.append(MATCH_GLYPH if a == b else MISMATCH_GLYPH)
            out_2.append(b)
            level = code & 3
            i -= 1
            j -= 1
        elif level == LEVEL_IX:
            out_1.append(GAP_CHAR)
            mid.append(GAP_GLYPH)
            out_2.append(seq_2[j - 1])
            level = (code >> 2) & 3
            j -= 1
        else:
            out_1.append(seq_1[i - 1])
            mid.append(GAP_GLYPH)
            out_2.append(GAP_CHAR)
            level = (code >> 4) & 3
            i -= 1

    out_1.reverse()
    mid.reverse()
    out_2.reverse()
    return Traceback("".join(out_1), "".join(mid), "".join(out_2), cost)


def alignment_cost(
    seq_1_aligned: str,
    seq_2_aligned: str,
    costing,
    gap_open_cost: int,
) -> int:
    """Independently re-price an alignment under the costing scheme.

    Used by property tests to assert traced-path cost == fill cost.  Charges
    ``gap_open_cost`` on every entry into a gap run (including length-1 runs),
    matching the reference's transition convention (globaligner.py:342-357).

    Args:
        costing: a SubstitutionMatrix (costing space).
    """
    look = costing.lookup
    total = 0
    prev_level = LEVEL_M
    for ca, cb in zip(seq_1_aligned, seq_2_aligned):
        if ca != GAP_CHAR and cb != GAP_CHAR:
            total += look(ca, cb)
            prev_level = LEVEL_M
        elif ca == GAP_CHAR:
            if prev_level != LEVEL_IX:
                total += gap_open_cost
            total += look(GAP_CHAR, cb)
            prev_level = LEVEL_IX
        else:
            if prev_level != LEVEL_IY:
                total += gap_open_cost
            total += look(ca, GAP_CHAR)
            prev_level = LEVEL_IY
    return total


def alignment_to_cigar(
    seq_1_aligned: str, seq_2_aligned: str, *, extended: bool = True
) -> str:
    """CIGAR string for an aligned pair (seq_1 = query, seq_2 = reference).

    SAM conventions: ``I`` consumes query only (gap in seq_2), ``D``
    consumes reference only (gap in seq_1).  With ``extended`` (default)
    matches/mismatches are ``=``/``X``; otherwise both collapse to ``M``.
    The reference package has no CIGAR emitter; this is part of the batch
    engine's interchange surface (BASELINE.json configs).
    """
    if len(seq_1_aligned) != len(seq_2_aligned):
        raise ValueError("aligned strings must have equal length")
    out: list[str] = []
    run_op = ""
    run_len = 0
    for ca, cb in zip(seq_1_aligned, seq_2_aligned):
        if ca == GAP_CHAR and cb == GAP_CHAR:
            raise ValueError("gap aligned to gap")
        if ca == GAP_CHAR:
            op = "D"
        elif cb == GAP_CHAR:
            op = "I"
        elif extended:
            op = "=" if ca == cb else "X"
        else:
            op = "M"
        if op == run_op:
            run_len += 1
        else:
            if run_len:
                out.append(f"{run_len}{run_op}")
            run_op = op
            run_len = 1
    if run_len:
        out.append(f"{run_len}{run_op}")
    return "".join(out)
