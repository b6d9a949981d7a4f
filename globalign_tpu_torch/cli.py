"""Command-line front end.

Option parity with the reference CLI (src/globalign/globaligner.py:23-129):
the same 13 options plus ``--version``, forwarded verbatim into
``find_global_alignment`` and written via ``AlignmentResults.write()``.

Run as ``python -m globalign_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import sys


def _version() -> str:
    try:
        from importlib.metadata import version

        return version("globalign-tpu")
    except Exception:
        from . import __version__

        return __version__


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpalign",
        description=(
            "Perform optimal global alignment of two nucleotide or amino "
            "acid sequences."
        ),
    )
    parser.add_argument(
        "--version",
        action="version",
        version=_version(),
        help="Prints the version and exits.",
    )
    parser.add_argument(
        "-i",
        "--input_fasta",
        required=False,
        help=(
            "File path to a FASTA file containing two sequences to align.  "
            "Do not include if seq_1 and seq_2 are provided.  If the file "
            "contains more than 2 sequences, only the first 2 will be used."
        ),
    )
    parser.add_argument(
        "-o",
        "--output",
        required=False,
        help=(
            "Output file path to which a file containing the global "
            "alignment will be written.  If not provided, then the alignment "
            "will be written to stdout."
        ),
    )
    parser.add_argument(
        "--seq_1",
        required=False,
        help="First sequence to align.  Do not include if input_fasta is provided.",
    )
    parser.add_argument(
        "--seq_2",
        required=False,
        help="Second sequence to align.  Do not include if input_fasta is provided.",
    )
    parser.add_argument(
        "--scoring_mat_name",
        required=False,
        choices=["BLOSUM50", "BLOSUM62"],
        help=(
            "Either 'BLOSUM50' or 'BLOSUM62'.  Do not include this option if "
            "you would like to use a different scoring scheme or if you are "
            "aligning nucleotide sequences.  If set, then none of the other "
            "options with scores or costs should be set, except for the "
            "gap_open options."
        ),
    )
    parser.add_argument(
        "--scoring_mat_path",
        required=False,
        help=(
            "File path to a custom scoring matrix file.  If set, then none "
            "of the other options with scores or costs should be set, except "
            "for the gap_open options."
        ),
    )
    parser.add_argument(
        "--match_score",
        required=False,
        help=(
            "Score for a match.  Should be positive.  Only used if "
            "scoring_mat is not specified.  If set, then none of the options "
            "with costs should be set.  Default: 2."
        ),
    )
    parser.add_argument(
        "--mismatch_score",
        required=False,
        help=(
            "Score for a mismatch.  Should be negative.  Only used if "
            "scoring_mat is not specified.  If set, then none of the options "
            "with costs should be set.  Default: -3."
        ),
    )
    parser.add_argument(
        "--mismatch_cost",
        required=False,
        help=(
            "Cost for a mismatch.  Should be positive.  If set, then none of "
            "the options with scores should be set.  Default: 5."
        ),
    )
    parser.add_argument(
        "--gap_open_score",
        required=False,
        help=(
            "Score for opening a run of gaps.  It is accumulated even for a "
            "run with just one gap in it.  Should be non-positive.  Only used "
            "if scoring_mat is not specified.  If set, then none of the "
            "options with costs should be set.  Default: -4."
        ),
    )
    parser.add_argument(
        "--gap_open_cost",
        required=False,
        help=(
            "Cost for opening a run of gaps.  It is accumulated even for a "
            "run with just one gap in it.  Should be non-negative.  If set, "
            "then none of the options with scores should be set.  Default: 4."
        ),
    )
    parser.add_argument(
        "--gap_extension_score",
        required=False,
        help=(
            "Score for extending a run of gaps.  It is accumulated even for "
            "a run with just one gap in it.  Should be negative.  Only used "
            "if scoring_mat is not specified.  If set, then none of the "
            "options with costs should be set.  Default: -2."
        ),
    )
    parser.add_argument(
        "--gap_extension_cost",
        required=False,
        help=(
            "Cost for extending a run of gaps.  It is accumulated even for a "
            "run with just one gap in it.  Should be positive.  If set, then "
            "none of the options with scores should be set.  Default: 3."
        ),
    )
    parser.add_argument(
        "--device",
        required=False,
        choices=["cuda", "cpu"],
        default="cuda",
        help=(
            "Device to run the alignment engine on (engine extension): "
            "'cuda' (default) runs the CUDA fill kernel and fails when no "
            "GPU is present; 'cpu' runs the plain PyTorch engine."
        ),
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    kwargs = vars(args)

    from .api import find_global_alignment

    results = find_global_alignment(**kwargs)
    results.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
