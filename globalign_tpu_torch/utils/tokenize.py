"""Sequence tokenization for the TPU alignment engine.

The reference (globalign) keeps sequences as Python strings and substitution
matrices as nested dicts keyed by single characters, with the gap symbol "-"
as a first-class key (reference: src/globalign/start.py:437-448, DP lookups at
src/globalign/globaligner.py:336,347,357).  On TPU we instead tokenize each
sequence into int32 ids over a fixed alphabet and hold the substitution matrix
as a dense ``(A, A)`` int32 array, so the hot DP loop is pure vector math with
small-table gathers instead of dict-of-dict lookups.

Conventions:
  * The alphabet always contains the gap symbol ``"-"`` as its LAST entry.
  * For "simple" schemes the alphabet is the sorted union of the characters in
    both sequences plus the gap (matching reference start.py:355-358 plus the
    append of "-" at start.py:437/456).
  * For matrix schemes (BLOSUM / custom file) the alphabet is the matrix
    header order (reference start.py:391-395).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

GAP = "-"


@dataclass(frozen=True)
class Alphabet:
    """A fixed character alphabet with the gap symbol as the last token."""

    letters: tuple[str, ...]  # includes GAP, typically last

    _index: dict = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if GAP not in self.letters:
            raise ValueError("Alphabet must include the gap symbol '-'.")
        object.__setattr__(
            self, "_index", {c: i for i, c in enumerate(self.letters)}
        )

    @classmethod
    def from_sequences(cls, *seqs: str) -> "Alphabet":
        """Sorted union of the sequence characters, gap appended last.

        Mirrors the reference's ``get_common_alphabet`` + append-"-" behavior
        (start.py:355-358, start.py:437).
        """
        chars = sorted(set().union(*[set(s) for s in seqs]))
        if GAP in chars:
            raise ValueError("Sequences may not contain the gap symbol '-'.")
        return cls(tuple(chars) + (GAP,))

    @classmethod
    def from_letters(cls, letters) -> "Alphabet":
        return cls(tuple(letters))

    @property
    def size(self) -> int:
        return len(self.letters)

    @property
    def gap_id(self) -> int:
        return self._index[GAP]

    def index(self, char: str) -> int:
        return self._index[char]

    def __contains__(self, char: str) -> bool:
        return char in self._index

    def encode(self, seq: str) -> np.ndarray:
        """Tokenize a string into int32 ids.  Raises KeyError on unknown chars."""
        try:
            return np.fromiter(
                (self._index[c] for c in seq), dtype=np.int32, count=len(seq)
            )
        except KeyError as e:
            raise ValueError(
                f"Sequence contains character {e.args[0]!r} not present in the "
                f"alphabet {list(self.letters)!r}."
            ) from None

    def decode(self, tokens) -> str:
        letters = self.letters
        return "".join(letters[int(t)] for t in tokens)


def encode_padded(alphabet: Alphabet, seq: str, padded_len: int) -> np.ndarray:
    """Tokenize ``seq`` into a 1-origin padded buffer of length ``padded_len + 1``.

    Position ``i`` (1-based) holds the token of ``seq[i-1]``; position 0 and the
    tail padding hold 0 (an arbitrary valid token — the DP fill masks them out).
    This 1-origin layout matches the DP array indexing where row/column 0 is the
    boundary (reference globaligner.py:766-777).
    """
    if len(seq) > padded_len:
        raise ValueError("padded_len is smaller than the sequence length")
    out = np.zeros(padded_len + 1, dtype=np.int32)
    out[1 : len(seq) + 1] = alphabet.encode(seq)
    return out
