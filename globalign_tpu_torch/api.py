"""Public API — ``find_global_alignment`` with the reference's exact surface.

A drop-in for the reference's one public entry point
(src/globalign/globaligner.py:132-314): same 13 keyword arguments, same
defaults and validation semantics, same ``AlignmentResults`` shape.  The
engine underneath is the port's: the CUDA fill kernel on the card, or the
plain PyTorch row scan when ``device="cpu"`` is passed.

One documented behavioral difference: where multiple optimal alignments
exist, the reference picks one at random (unseeded ``random.choice``,
globaligner.py:598-672); this engine picks deterministically (tie priority
match/mismatch > gap-in-seq_1 > gap-in-seq_2).  Scores and costs are
bit-identical to the reference either way.
"""

from __future__ import annotations

from pathlib import Path

from .config import DEFAULT_MAX_SEQ_LEN_PROD, validate_and_transform_args
from .models.gotoh import GotohAligner
from .results import AlignmentResults


def find_global_alignment(
    input_fasta: str | Path | None = None,
    output: str | Path | None = None,
    seq_1: str | None = None,
    seq_2: str | None = None,
    scoring_mat_name: str | None = None,
    scoring_mat_path: str | Path | None = None,
    match_score: str | int | None = None,
    mismatch_score: str | int | None = None,
    mismatch_cost: str | int | None = None,
    gap_open_score: str | int | None = None,
    gap_open_cost: str | int | None = None,
    gap_extension_score: str | int | None = None,
    gap_extension_cost: str | int | None = None,
    max_seq_len_prod: int = DEFAULT_MAX_SEQ_LEN_PROD,
    device: str = "cuda",
) -> AlignmentResults:
    """Optimal global (Needleman-Wunsch/Gotoh affine-gap) alignment of two sequences.

    Args mirror the reference CLI/API one-to-one (globaligner.py:132-214):
        input_fasta: FASTA file with the two sequences (exclusive with
            seq_1/seq_2; only the first two records are used).
        output: report destination path (stdout if None).  Refuses to
            overwrite an existing file.
        seq_1, seq_2: the sequences to align (exclusive with input_fasta).
        scoring_mat_name: 'BLOSUM50' or 'BLOSUM62' (bundled matrices).
        scoring_mat_path: custom whitespace-format scoring-matrix file.
        match_score / mismatch_score / gap_open_score / gap_extension_score:
            simple scoring scheme (defaults 2 / -3 / -4 / -2).
        mismatch_cost / gap_open_cost / gap_extension_cost: simple costing
            scheme (defaults 5 / 4 / 3).  Score and cost options are mutually
            exclusive; gap_open score/cost are always coupled as opposites.
        max_seq_len_prod: engine guard on m*n (new knob; the reference
            hard-coded 20_000_000 at start.py:213).
        device: 'cuda' (default; raises if no GPU is present) or 'cpu'
            (engine extension, like the JAX CLI's ``--platform``).

    Returns:
        AlignmentResults (same 10 fields as the reference's).
    """
    good = validate_and_transform_args(
        input_fasta=input_fasta,
        output=output,
        seq_1=seq_1,
        seq_2=seq_2,
        scoring_mat_name=scoring_mat_name,
        scoring_mat_path=scoring_mat_path,
        match_score=match_score,
        mismatch_score=mismatch_score,
        mismatch_cost=mismatch_cost,
        gap_open_score=gap_open_score,
        gap_open_cost=gap_open_cost,
        gap_extension_score=gap_extension_score,
        gap_extension_cost=gap_extension_cost,
        max_seq_len_prod=max_seq_len_prod,
    )

    aligner = GotohAligner(good.scheme, device=device)
    alignment = aligner.align(good.seq_1, good.seq_2)

    return AlignmentResults(
        seq_1_aligned=alignment.seq_1_aligned,
        middle_part=alignment.middle_part,
        seq_2_aligned=alignment.seq_2_aligned,
        cost=alignment.cost,
        score=alignment.score,
        scoring_mat=good.scheme.scoring.to_nested_dict(),
        costing_mat=good.scheme.costing.to_nested_dict(),
        gap_open_score=good.scheme.gap_open_score,
        gap_open_cost=good.scheme.gap_open_cost,
        output=good.output,
    )
