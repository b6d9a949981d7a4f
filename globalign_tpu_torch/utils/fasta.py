"""FASTA input (NCBI spec) — streaming reader and pair extraction.

Capability parity with the reference reader (src/globalign/start.py:614-688):
``read_seq_from_fasta`` is a generator of ``(description, sequence)`` tuples
with upper-cased, multi-line-joined sequences; it raises on a missing leading
``>`` line and on empty sequences.  ``read_first_2_seqs_from_fasta`` pulls the
first two records.

``iter_fasta_pairs`` streams consecutive record pairs for the batched
many-pair front end (SURVEY.md §2, host-side streaming front end), without
materializing the whole file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator


def read_seq_from_fasta(fasta_path: Path | str) -> Iterator[tuple[str, str]]:
    """Yield (description, sequence) records from a FASTA file.

    The pure-Python reader of ``globalign_tpu/utils/fasta.py``; the native
    C++ parser is not used by the port.

    Raises:
        RuntimeError: on invalid format (no leading '>', empty sequence).
    """
    fasta_path = Path(fasta_path)
    with fasta_path.open() as f:
        desc = None
        chunks: list[str] = []
        for raw in f:
            line = raw.strip()
            if not line and desc is None:
                continue
            if desc is None:
                if not line.startswith(">"):
                    raise RuntimeError(
                        "Invalid FASTA format. Expected the first line to "
                        "start with '>'."
                    )
                desc = line
                continue
            if line.startswith(">"):
                seq = "".join(chunks).upper()
                if not seq:
                    raise RuntimeError("Empty sequence detected in FASTA.")
                yield (desc, seq)
                desc = line
                chunks.clear()
            elif line:
                chunks.append(line)

        if desc is None:
            raise RuntimeError(
                "Invalid FASTA format. Expected the first line to start with '>'."
            )
        seq = "".join(chunks).upper()
        if not seq:
            raise RuntimeError("Empty sequence detected in FASTA.")
        yield (desc, seq)


def read_first_2_seqs_from_fasta(fasta_path: Path | str) -> tuple[str, str]:
    """First two sequences of a FASTA file (reference start.py:666-688).

    Raises:
        RuntimeError: if fewer than two records exist.
    """
    it = read_seq_from_fasta(fasta_path)
    try:
        _, seq_1 = next(it)
        _, seq_2 = next(it)
    except StopIteration:
        raise RuntimeError(
            "Two sequences could not be read from the FASTA file."
        ) from None
    return seq_1, seq_2


def iter_fasta_pairs(
    fasta_path: Path | str,
) -> Iterator[tuple[tuple[str, str], tuple[str, str]]]:
    """Stream consecutive record pairs ((desc1, seq1), (desc2, seq2)).

    Records 1&2 form the first pair, 3&4 the second, and so on.  A trailing
    unpaired record raises RuntimeError.
    """
    it = read_seq_from_fasta(fasta_path)
    while True:
        try:
            first = next(it)
        except StopIteration:
            return
        try:
            second = next(it)
        except StopIteration:
            raise RuntimeError(
                "FASTA file has an odd number of records; pairs require an "
                "even count."
            ) from None
        yield (first, second)
