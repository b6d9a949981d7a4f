"""Alignment results object and human-readable report writer.

Format parity with the reference's ``AlignmentResults``
(src/globalign/conclude.py:7-151) and matrix pretty-printer
(conclude.py:252-310): same 10 fields, same printout layout (desc lines,
70-char-wrapped seq/middle/seq triplets, ``score:``/``cost:`` lines, a
``# Settings`` block with both matrices and gap-open values), same
stdout/file routing in ``write`` (mode ``w+``), verified against the tutorial
goldens (reference/tutorial.qmd:15-47).

The matrices are exposed as nested dicts — the reference's public matrix
format — even though the engine computes with dense arrays internally.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple


class AlignmentResults(NamedTuple):
    seq_1_aligned: str
    middle_part: str
    seq_2_aligned: str
    cost: int
    score: int
    scoring_mat: dict
    costing_mat: dict
    gap_open_score: int
    gap_open_cost: int
    output: Path | None

    def cigar(self, extended: bool = True) -> str:
        """CIGAR string of the alignment (seq_1 = query, seq_2 = reference;
        '='/'X'/'I'/'D' extended ops by default, classic 'M' otherwise)."""
        from .ops.traceback import alignment_to_cigar

        return alignment_to_cigar(
            self.seq_1_aligned, self.seq_2_aligned, extended=extended
        )

    def _generate_alignment_printout(
        self,
        desc_1: str = "seq_1",
        desc_2: str = "seq_2",
        chars_per_line: int = 70,
    ):
        alignment_len = len(self.middle_part)
        num_blocks = max(1, math.ceil(alignment_len / chars_per_line))

        yield desc_1
        yield "\n"
        yield desc_2

        for u in range(num_blocks):
            lo = u * chars_per_line
            hi = lo + chars_per_line
            yield "\n\n"
            yield self.seq_1_aligned[lo:hi]
            yield "\n"
            yield self.middle_part[lo:hi]
            yield "\n"
            yield self.seq_2_aligned[lo:hi]

        yield "\n\n"
        yield f"score: {self.score}\n"
        yield f"cost: {self.cost}\n"
        yield (
            "###########################################\n"
            "# Settings\n"
            "###########################################\n"
        )
        yield "scoring_mat:\n"
        yield prettify_mat(self.scoring_mat)
        yield f"\n\ngap_open_score: {self.gap_open_score}\n"
        yield "\ncosting_mat:\n"
        yield prettify_mat(self.costing_mat)
        yield f"\n\ngap_open_cost: {self.gap_open_cost}\n"

    def __str__(
        self,
        desc_1: str = "seq_1",
        desc_2: str = "seq_2",
        chars_per_line: int = 70,
    ) -> str:
        return "".join(
            self._generate_alignment_printout(
                desc_1=desc_1, desc_2=desc_2, chars_per_line=chars_per_line
            )
        )

    def print(
        self,
        desc_1: str = "seq_1",
        desc_2: str = "seq_2",
        chars_per_line: int = 70,
    ) -> None:
        print(
            self.__str__(
                desc_1=desc_1, desc_2=desc_2, chars_per_line=chars_per_line
            )
        )

    def write(
        self,
        file: Path | str | None = None,
        desc_1: str = "seq_1",
        desc_2: str = "seq_2",
        chars_per_line: int = 70,
    ) -> None:
        """Write the report to ``file``, ``self.output``, or stdout.

        Routing parity with reference conclude.py:107-151: ``file`` overrides
        ``self.output``; the literal string "stdout" (or both being None)
        selects standard output.
        """
        if (file is None and self.output is None) or file == "stdout":
            self.print(
                desc_1=desc_1, desc_2=desc_2, chars_per_line=chars_per_line
            )
            return
        target = self.output if file is None else file
        text = self.__str__(
            desc_1=desc_1, desc_2=desc_2, chars_per_line=chars_per_line
        )
        with open(file=target, mode="w+") as fh:
            fh.write(text)


def prettify_mat(mat: dict) -> str:
    """Right-aligned rendering of a nested-dict matrix.

    Layout parity with reference conclude.py:252-310: column widths are
    ``max(len(header), widest cell) + 1``, row headers are left-aligned in
    ``longest_header + 1`` columns, and the header line starts with
    ``longest_header + 1`` spaces.
    """
    try:
        col_headers = list(next(iter(mat.values())).keys())
    except Exception:
        print("mat does not appear to represent a matrix as a nested dictionary.")
        raise

    widths = []
    for col in col_headers:
        w = len(str(col))
        for row in mat:
            w = max(w, len(str(mat[row][col])))
        widths.append(w)

    header_w = max(len(str(h)) for h in col_headers)
    parts = [" " * (header_w + 1)]
    parts.extend(f"{str(h):>{w + 1}}" for h, w in zip(col_headers, widths))
    for row in mat:
        parts.append("\n")
        parts.append(f"{str(row):<{header_w + 1}}")
        parts.extend(
            f"{str(mat[row][col]):>{w + 1}}" for col, w in zip(col_headers, widths)
        )
    return "".join(parts)


def print_nested_list_aligned(nested_list: list) -> None:
    """Pretty-print a nested list with right-aligned columns.

    Debugging aid for DP arrays (parity with reference conclude.py:204-249).
    """
    num_cols = len(nested_list[0])
    widths = [
        max(len(str(row[j])) for row in nested_list) for j in range(num_cols)
    ]
    lines = []
    for row in nested_list:
        lines.append(
            "".join(f"{str(cell):>{w + 1}}" for cell, w in zip(row, widths))
        )
    print("\n".join(lines) + "\n")
