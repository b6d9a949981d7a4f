"""Substitution-matrix I/O, synthesis, and validation.

Re-implements the capabilities of the reference's scoring-scheme layer
(reference: src/globalign/start.py:378-497 and :883-939) on top of a dense
int32 array representation instead of nested dicts:

  * ``read_scoring_mat``      — whitespace .mtx parser   (start.py:378-428)
  * ``create_scoring_mat``    — simple-scheme synthesis   (start.py:431-449)
  * ``create_costing_mat``    — simple-scheme synthesis   (start.py:451-468)
  * ``check_symmetric`` / ``check_big_main_diag`` / ``validate_scoring_mat_keys``
                              — matrix validation         (start.py:883-939, :471-485)
  * ``get_max_val``           — matrix max                (start.py:488-497)
  * bundled BLOSUM50/BLOSUM62/nucleotide data             (src/globalign/data)

The public nested-dict forms are kept at the API boundary for drop-in parity
with the reference; internally everything is an ``(A, A)`` numpy int32 array
aligned with an :class:`~globalign_tpu_torch.utils.tokenize.Alphabet`.

A copy of ``globalign_tpu/utils/matrices.py`` that reads this package's
own data files, so the port never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from importlib import resources
from pathlib import Path

import numpy as np

from .tokenize import GAP, Alphabet

BUNDLED_MATRIX_NAMES = ("BLOSUM50", "BLOSUM62", "nucleotide")


@dataclass(frozen=True)
class SubstitutionMatrix:
    """A dense substitution matrix over a fixed alphabet (gap included)."""

    alphabet: Alphabet
    values: np.ndarray  # (A, A) int32

    def __post_init__(self):
        a = self.alphabet.size
        if self.values.shape != (a, a):
            raise ValueError(
                f"matrix shape {self.values.shape} does not match alphabet size {a}"
            )

    def lookup(self, char_a: str, char_b: str) -> int:
        return int(
            self.values[self.alphabet.index(char_a), self.alphabet.index(char_b)]
        )

    def max_val(self) -> int:
        """Max entry of the matrix (reference ``get_max_val``, start.py:488-497)."""
        return int(self.values.max())

    def to_nested_dict(self) -> dict:
        """Nested-dict view matching the reference's public matrix format."""
        letters = self.alphabet.letters
        return {
            ra: {cb: int(self.values[i, j]) for j, cb in enumerate(letters)}
            for i, ra in enumerate(letters)
        }

    @classmethod
    def from_nested_dict(cls, mat: dict) -> "SubstitutionMatrix":
        letters = tuple(mat.keys())
        alphabet = Alphabet.from_letters(letters)
        a = len(letters)
        values = np.zeros((a, a), dtype=np.int32)
        for i, ra in enumerate(letters):
            row = mat[ra]
            for j, cb in enumerate(letters):
                values[i, j] = int(row[cb])
        return cls(alphabet, values)

    def restrict_check(self, required: Alphabet) -> None:
        """Check every required letter exists in this matrix's alphabet.

        Mirrors ``validate_scoring_mat_keys`` (reference start.py:471-485).
        """
        missing = [c for c in required.letters if c not in self.alphabet]
        if missing:
            raise RuntimeError(
                f"common_alphabet contains values not in scoring_mat_keys, "
                f"e.g. {set(missing)}.  Please check your sequences and your "
                f"scoring matrix."
            )


def read_scoring_mat(scoring_mat_path: Path | str) -> SubstitutionMatrix:
    """Parse a whitespace-separated scoring-matrix file.

    Format parity with the reference parser (start.py:378-428): a header row of
    single letters; each body row starts with its letter (which must match the
    header order) followed by one integer per column.  Extensions over the
    reference: lines starting with ``#`` are ignored (lets data files carry
    provenance comments), and letters are upper-cased as in the reference.

    Raises:
        FileNotFoundError: if the path is not a file.
        RuntimeError: if the header has multi-character tokens or row labels
            do not match the header.
    """
    scoring_mat_path = Path(scoring_mat_path)
    if not scoring_mat_path.is_file():
        raise FileNotFoundError("scoring_mat_path does not point to a valid file.")

    with scoring_mat_path.open() as f:
        lines = [ln for ln in f if ln.strip() and not ln.lstrip().startswith("#")]

    if not lines:
        raise RuntimeError("The scoring matrix file is empty.")

    letters = lines[0].upper().split()
    if not all(len(letter) == 1 for letter in letters):
        raise RuntimeError("The header row did not have single letters spaced apart.")

    a = len(letters)
    values = np.zeros((a, a), dtype=np.int32)
    body = lines[1:]
    if len(body) != a:
        raise RuntimeError(
            f"Expected {a} matrix rows to match the header, found {len(body)}."
        )
    for i, line in enumerate(body):
        fields = line.split()
        row_label = fields[0].upper()
        if row_label != letters[i]:
            raise RuntimeError("Row headers do not match column headers.")
        if len(fields) != a + 1:
            raise RuntimeError(
                f"Row {row_label!r} has {len(fields) - 1} entries, expected {a}."
            )
        values[i, :] = [int(x) for x in fields[1:]]

    return SubstitutionMatrix(Alphabet.from_letters(letters), values)


def load_bundled_matrix(name: str) -> SubstitutionMatrix:
    """Load a matrix bundled with the package (BLOSUM50/BLOSUM62/nucleotide).

    Mirrors the reference's importlib.resources loading (start.py:265-273).
    """
    if name not in BUNDLED_MATRIX_NAMES:
        raise ValueError(
            f"Unknown bundled matrix {name!r}; available: {BUNDLED_MATRIX_NAMES}"
        )
    data_root = resources.files("globalign_tpu_torch.data")
    mtx = data_root.joinpath("scoring_matrices", f"{name}.mtx")
    with resources.as_file(mtx) as f:
        return read_scoring_mat(f)


def create_scoring_mat(
    alphabet: Alphabet, match_score: int, mismatch_score: int, gap_extension_score: int
) -> SubstitutionMatrix:
    """Synthesize a simple scoring matrix over ``alphabet`` (gap included).

    Semantics parity with reference start.py:431-449: the main diagonal gets
    ``match_score`` (including the gap/gap cell), gap row/column get
    ``gap_extension_score``, everything else ``mismatch_score``.
    """
    a = alphabet.size
    g = alphabet.gap_id
    values = np.full((a, a), mismatch_score, dtype=np.int32)
    values[g, :] = gap_extension_score
    values[:, g] = gap_extension_score
    np.fill_diagonal(values, match_score)
    return SubstitutionMatrix(alphabet, values)


def create_costing_mat(
    alphabet: Alphabet, mismatch_cost: int, gap_extension_cost: int
) -> SubstitutionMatrix:
    """Synthesize a simple costing matrix over ``alphabet`` (gap included).

    Semantics parity with reference start.py:451-468: zero on the main
    diagonal (including gap/gap), ``gap_extension_cost`` on the gap
    row/column, ``mismatch_cost`` elsewhere.
    """
    a = alphabet.size
    g = alphabet.gap_id
    values = np.full((a, a), mismatch_cost, dtype=np.int32)
    values[g, :] = gap_extension_cost
    values[:, g] = gap_extension_cost
    np.fill_diagonal(values, 0)
    return SubstitutionMatrix(alphabet, values)


def check_symmetric(mat) -> bool:
    """True iff the matrix is symmetric.

    Accepts either a :class:`SubstitutionMatrix` or the reference's
    nested-dict form (start.py:883-912).  For nested dicts, a row set that
    differs from the column set returns False; non-dict input raises
    AttributeError, matching the reference's error surface
    (tests/start_test.py:42-65).
    """
    if isinstance(mat, SubstitutionMatrix):
        return bool((mat.values == mat.values.T).all())
    try:
        keys = list(mat.keys())
    except AttributeError:
        print("The check_symmetric function expected a nested dictionary.")
        raise
    for outer in keys:
        for inner in keys:
            try:
                if mat[outer][inner] != mat[inner][outer]:
                    return False
            except (KeyError, TypeError):
                return False
            except AttributeError:
                print("The check_symmetric function expected a nested dictionary.")
                raise
    return True


def check_big_main_diag(mat) -> bool:
    """True iff every row's maximum lies on the main diagonal.

    Parity with reference start.py:915-939.
    """
    if isinstance(mat, SubstitutionMatrix):
        v = mat.values
        return bool((np.diag(v) == v.max(axis=1)).all())
    for outer in mat.keys():
        row_max = max(mat[outer].values())
        try:
            if mat[outer][outer] != row_max:
                return False
        except KeyError:
            raise RuntimeError(
                "mat is not a proper nested dict representation of a matrix."
            )
    return True


def validate_scoring_mat_keys(scoring_mat_keys, common_alphabet) -> None:
    """Check the matrix covers the sequence alphabet plus the gap symbol.

    Parity with reference start.py:471-485 (including mutating semantics of
    appending "-" to the caller's list being avoided here — we work on a copy).
    """
    required = list(common_alphabet) + [GAP]
    diff = set(required).difference(scoring_mat_keys)
    if diff:
        raise RuntimeError(
            f"common_alphabet contains values not in scoring_mat_keys, e.g. "
            f"{diff}.  Please check your sequences and your scoring matrix."
        )


def get_max_val(mat) -> int:
    """Max value of a matrix in either representation (start.py:488-497)."""
    if isinstance(mat, SubstitutionMatrix):
        return mat.max_val()
    return max(max(inner.values()) for inner in mat.values())
