"""Argument validation and scoring-scheme resolution.

Semantics parity with the reference's validation layer
(src/globalign/start.py:10-353):

  * the 13-option surface and its mutual-exclusion rules (start.py:201-232),
  * simple-scheme defaults with int coercion and sign checks
    (``SimpleScoringSettings`` / ``SimpleCostingSettings``, start.py:10-147),
  * the gap_open score/cost coupling ``gap_open_score == -gap_open_cost``
    (start.py:249-262),
  * the four scheme-resolution branches — named BLOSUM, custom matrix file,
    simple costs, simple scores/default (start.py:265-343),
  * output-path checks, '-'-free sequences, upper-casing, length checks
    (start.py:184-220).

Differences by design (documented in SURVEY.md):
  * matrices resolve to a :class:`ResolvedScheme` holding dense int32 arrays
    (the nested-dict views are materialized only at the results boundary);
  * the reference's hard cap ``len(seq_1) * len(seq_2) < 20_000_000``
    (start.py:213) existed because its interpreted O(m·n) fill could not
    scale; the TPU engine lifts it to a memory-motivated default that can be
    overridden (``max_seq_len_prod``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .ops.transforms import (
    costing_mat_to_scoring_mat,
    scoring_mat_to_costing_mat,
    split_deltas,
)
from .utils.fasta import read_first_2_seqs_from_fasta
from .utils.matrices import (
    SubstitutionMatrix,
    check_big_main_diag,
    check_symmetric,
    create_costing_mat,
    create_scoring_mat,
    load_bundled_matrix,
    read_scoring_mat,
)
from .utils.spans import span
from .utils.tokenize import GAP, Alphabet

# TPU-era guard: ~2e12 cells is past any sane single-pair HBM/time budget;
# the reference capped at 2e7 (start.py:213) because of its Python fill.
DEFAULT_MAX_SEQ_LEN_PROD = 2_000_000_000_000


def _coerce_int(value, name: str) -> int:
    try:
        return int(value)
    except (TypeError, ValueError) as e:
        print(f"{name} must be convertible to an integer.")
        raise e


@dataclass
class SimpleScoringSettings:
    """Simple scoring-scheme settings (reference start.py:10-91).

    Defaults: match +2, mismatch -3, gap_open -4, gap_extension -2; string
    inputs are coerced to int; sign conventions are enforced.
    """

    match_score: int | str | None = 2
    mismatch_score: int | str | None = -3
    gap_open_score: int | str | None = -4
    gap_extension_score: int | str | None = -2

    def __post_init__(self):
        self.match_score = _coerce_int(
            2 if self.match_score is None else self.match_score, "match_score"
        )
        self.mismatch_score = _coerce_int(
            -3 if self.mismatch_score is None else self.mismatch_score,
            "mismatch_score",
        )
        self.gap_open_score = _coerce_int(
            -4 if self.gap_open_score is None else self.gap_open_score,
            "gap_open_score",
        )
        self.gap_extension_score = _coerce_int(
            -2 if self.gap_extension_score is None else self.gap_extension_score,
            "gap_extension_score",
        )
        if self.match_score <= 0:
            raise ValueError("match_score must be positive")
        if self.mismatch_score >= 0:
            raise ValueError("mismatch_score must be negative")
        if self.gap_open_score > 0:
            raise ValueError("gap_open_score must be non-positive")
        if self.gap_extension_score >= 0:
            raise ValueError("gap_extension_score must be negative")


@dataclass
class SimpleCostingSettings:
    """Simple costing-scheme settings (reference start.py:93-147).

    Defaults: mismatch 5, gap_open 4, gap_extension 3.
    """

    mismatch_cost: int | str | None = 5
    gap_open_cost: int | str | None = 4
    gap_extension_cost: int | str | None = 3

    def __post_init__(self):
        self.mismatch_cost = _coerce_int(
            5 if self.mismatch_cost is None else self.mismatch_cost, "mismatch_cost"
        )
        self.gap_open_cost = _coerce_int(
            4 if self.gap_open_cost is None else self.gap_open_cost, "gap_open_cost"
        )
        self.gap_extension_cost = _coerce_int(
            3 if self.gap_extension_cost is None else self.gap_extension_cost,
            "gap_extension_cost",
        )
        if self.mismatch_cost <= 0:
            raise ValueError("mismatch_cost must be positive")
        if self.gap_open_cost < 0:
            raise ValueError("gap_open_cost must be non-negative")
        if self.gap_extension_cost <= 0:
            raise ValueError("gap_extension_cost must be positive")


@dataclass(frozen=True)
class ResolvedScheme:
    """A fully resolved alignment scheme, ready for the device engine."""

    alphabet: Alphabet
    scoring: SubstitutionMatrix
    costing: SubstitutionMatrix
    gap_open_score: int
    gap_open_cost: int
    max_score: int  # b = max over the scoring matrix (drives delta_d/delta_i)

    @property
    def deltas(self) -> tuple[int, int]:
        return split_deltas(self.max_score)


def scheme_from_arrays(
    letters,
    scoring_values,
    costing_values,
    gap_open_score: int,
    gap_open_cost: int,
    max_score: int,
) -> ResolvedScheme:
    """Build a :class:`ResolvedScheme` from plain fields.

    ``letters`` is the alphabet (gap included) and the two value arrays are
    the (A, A) scoring and costing matrices over it — the fields of a
    ``globalign_tpu.config.ResolvedScheme`` given as numpy arrays, so one
    scheme can be handed to both packages without either importing the
    other.
    """
    alphabet = Alphabet.from_letters(letters)
    return ResolvedScheme(
        alphabet=alphabet,
        scoring=SubstitutionMatrix(
            alphabet, np.array(scoring_values, dtype=np.int32)
        ),
        costing=SubstitutionMatrix(
            alphabet, np.array(costing_values, dtype=np.int32)
        ),
        gap_open_score=int(gap_open_score),
        gap_open_cost=int(gap_open_cost),
        max_score=int(max_score),
    )


@dataclass(frozen=True)
class ValidatedArgs:
    seq_1: str
    seq_2: str
    scheme: ResolvedScheme
    output: Path | None


def check_seq_lengths(seq_1: str, seq_2: str, max_seq_len_prod: int) -> None:
    """Positive, bounded length product (reference start.py:361-376)."""
    m, n = len(seq_1), len(seq_2)
    prod = m * n
    if not prod < max_seq_len_prod:
        raise RuntimeError(
            f"Your sequences are too long.  The product of their lengths "
            f"should be less than {max_seq_len_prod}.  They have lengths of "
            f"{m} and {n}"
        )
    if prod == 0:
        raise RuntimeError("Detected a sequence of length 0.")


def resolve_scheme(
    seq_1: str,
    seq_2: str,
    scoring_mat_name=None,
    scoring_mat_path=None,
    match_score=None,
    mismatch_score=None,
    mismatch_cost=None,
    gap_open_score=None,
    gap_open_cost=None,
    gap_extension_score=None,
    gap_extension_cost=None,
) -> ResolvedScheme:
    """Resolve the scoring/costing scheme from user options.

    Implements the four branches of reference start.py:265-343 over dense
    matrices, with the gap_open coupling of start.py:249-262.
    """
    # Mutual-exclusion rules (start.py:227-232).
    others = (
        scoring_mat_path,
        match_score,
        mismatch_score,
        mismatch_cost,
        gap_extension_score,
        gap_extension_cost,
    )
    if scoring_mat_name is not None and any(x is not None for x in others):
        raise RuntimeError(
            "The scoring_mat_name should not be specified if any of the other "
            "options with scores or costs are specified, except for the "
            "gap_open options."
        )
    others_for_path = (
        scoring_mat_name,
        match_score,
        mismatch_score,
        mismatch_cost,
        gap_extension_score,
        gap_extension_cost,
    )
    if scoring_mat_path is not None and any(x is not None for x in others_for_path):
        raise RuntimeError(
            "The scoring_mat_path should not be specified if any of the other "
            "options with scores or costs are specified, except for the "
            "gap_open options."
        )
    score_opts = (match_score, mismatch_score, gap_open_score, gap_extension_score)
    cost_opts = (mismatch_cost, gap_open_cost, gap_extension_cost)
    if any(x is not None for x in score_opts) and any(
        x is not None for x in cost_opts
    ):
        raise RuntimeError("Scoring and costing options should not both be set.")

    scoring_settings = SimpleScoringSettings(
        match_score=match_score,
        mismatch_score=mismatch_score,
        gap_open_score=gap_open_score,
        gap_extension_score=gap_extension_score,
    )
    costing_settings = SimpleCostingSettings(
        mismatch_cost=mismatch_cost,
        gap_open_cost=gap_open_cost,
        gap_extension_cost=gap_extension_cost,
    )

    # gap_open score/cost are always opposites (start.py:249-262).
    if gap_open_score is not None:
        costing_settings.gap_open_cost = -scoring_settings.gap_open_score
    else:
        scoring_settings.gap_open_score = -costing_settings.gap_open_cost

    seq_alphabet = Alphabet.from_sequences(seq_1, seq_2)

    if scoring_mat_name is not None or scoring_mat_path is not None:
        if scoring_mat_name is not None:
            scoring = load_bundled_matrix(scoring_mat_name)
        else:
            scoring = read_scoring_mat(Path(scoring_mat_path))
            if not check_symmetric(scoring):
                raise RuntimeError("The scoring matrix is not symmetric.")
            if not check_big_main_diag(scoring):
                raise RuntimeError(
                    "The scoring matrix does not make sense because the "
                    "maximum for each row does not occur on the main diagonal."
                )
        scoring.restrict_check(seq_alphabet)
        max_score = scoring.max_val()
        costing = scoring_mat_to_costing_mat(scoring, max_score=max_score)
        alphabet = scoring.alphabet
    elif any(x is not None for x in cost_opts):
        alphabet = seq_alphabet
        costing = create_costing_mat(
            alphabet,
            mismatch_cost=costing_settings.mismatch_cost,
            gap_extension_cost=costing_settings.gap_extension_cost,
        )
        scoring = costing_mat_to_scoring_mat(
            costing, max_score=scoring_settings.match_score
        )
        max_score = scoring.max_val()
    else:
        alphabet = seq_alphabet
        scoring = create_scoring_mat(
            alphabet,
            match_score=scoring_settings.match_score,
            mismatch_score=scoring_settings.mismatch_score,
            gap_extension_score=scoring_settings.gap_extension_score,
        )
        costing = scoring_mat_to_costing_mat(
            scoring, max_score=scoring_settings.match_score
        )
        max_score = scoring.max_val()

    return ResolvedScheme(
        alphabet=alphabet,
        scoring=scoring,
        costing=costing,
        gap_open_score=scoring_settings.gap_open_score,
        gap_open_cost=costing_settings.gap_open_cost,
        max_score=max_score,
    )


def validate_and_transform_args(
    input_fasta=None,
    output=None,
    seq_1: str | None = None,
    seq_2: str | None = None,
    scoring_mat_name: str | None = None,
    scoring_mat_path=None,
    match_score=None,
    mismatch_score=None,
    mismatch_cost=None,
    gap_open_score=None,
    gap_open_cost=None,
    gap_extension_score=None,
    gap_extension_cost=None,
    max_seq_len_prod: int = DEFAULT_MAX_SEQ_LEN_PROD,
) -> ValidatedArgs:
    """Validate the full 13-option surface (reference start.py:150-353).

    Returns the validated sequences, the resolved scheme, and the output path.
    """
    # Output path (start.py:184-194): refuse to silently overwrite.
    if output is not None:
        output_p = Path(output)
        if output_p.is_file():
            raise RuntimeWarning(f"Overwriting {output_p}")
        if not output_p.parent.exists():
            raise FileNotFoundError(
                "The parent directory of output does not exist."
            )
        output_validated = output_p
    else:
        output_validated = None

    # fasta/seq_1/seq_2 combination rules (start.py:201-209).
    if input_fasta is not None and seq_1 is None and seq_2 is None:
        try:
            seq_1, seq_2 = read_first_2_seqs_from_fasta(Path(input_fasta))
        except FileNotFoundError:
            print(
                "input_fasta does not point to a valid file.  Please make "
                "sure it is in the correct FASTA format.  Note that reading "
                "from standard input is not supported at this time."
            )
            raise
    elif (
        (input_fasta is None and seq_2 is None)
        or (input_fasta is not None and seq_1 is not None)
        or (seq_1 is None and seq_2 is not None)
    ):
        raise RuntimeError(
            "The combination of arguments for input_fasta, seq_1, and seq_2 "
            "does not make sense."
        )

    check_seq_lengths(seq_1, seq_2, max_seq_len_prod)
    if GAP in seq_1 or GAP in seq_2:
        raise RuntimeError(
            "The current implementation does not allow for '-' characters in "
            "the sequences because they are used internally for gaps.  Please "
            "replace this character in your sequences."
        )
    seq_1 = seq_1.upper()
    seq_2 = seq_2.upper()

    with span("scheme"):
        scheme = resolve_scheme(
            seq_1,
            seq_2,
            scoring_mat_name=scoring_mat_name,
            scoring_mat_path=scoring_mat_path,
            match_score=match_score,
            mismatch_score=mismatch_score,
            mismatch_cost=mismatch_cost,
            gap_open_score=gap_open_score,
            gap_open_cost=gap_open_cost,
            gap_extension_score=gap_extension_score,
            gap_extension_cost=gap_extension_cost,
        )
    return ValidatedArgs(seq_1=seq_1, seq_2=seq_2, scheme=scheme, output=output_validated)
