"""globalign_tpu_torch — the PyTorch + CUDA port of globalign_tpu.

Optimal global (Needleman-Wunsch) alignment with affine gap penalties via
the Gotoh three-level recurrence in cost space, on an NVIDIA GPU: the DP
fill is a hand-written CUDA kernel (``csrc/gotoh_fill.cu``, built on first
use); the traceback walks its move codes on the host, or, past the moves
budget, block by block on the card (``csrc/walk_block.cu``).  The JAX
package ``globalign_tpu`` stays the reference; this package never imports
it or JAX, and gives identical alignments, costs, scores and reports.

The single-pair path (long pairs included) and batch serving are ported::

    find_global_alignment(..., device="cuda")   # reference-parity entry point
    GotohAligner(scheme, device="cuda")          # align / cost / dp_planes
    AlignmentResults                             # report object
    align_pairs(pairs, device="cuda")            # many pairs, bucketed
    python -m globalign_tpu_torch.batch_cli      # resumable batch runs

Batch cost fills run ``csrc/gotoh_batch.cu`` (a warp per pair).
``device="cpu"`` runs the plain PyTorch engine (the row scan of
``ops.fill_rows``); ``device="cuda"`` without a GPU raises.
"""

try:  # installed: the git-tag-derived version (setuptools-scm)
    from importlib.metadata import version as _pkg_version

    __version__ = _pkg_version("globalign-tpu")
except Exception:  # running from a source tree
    __version__ = "0.2.0"

from .api import find_global_alignment
from .batch import PairResult, align_pairs
from .config import (
    ResolvedScheme,
    SimpleCostingSettings,
    SimpleScoringSettings,
    resolve_scheme,
    scheme_from_arrays,
    validate_and_transform_args,
)
from .models.gotoh import GotohAligner, GotohAlignment
from .ops.traceback import alignment_to_cigar
from .ops.transforms import (
    costing_mat_to_scoring_mat,
    final_cost_to_score,
    final_score_to_cost,
    scoring_mat_to_costing_mat,
)
from .results import AlignmentResults, prettify_mat
from .runner import BatchRunner
from .utils.fasta import read_first_2_seqs_from_fasta, read_seq_from_fasta
from .utils.matrices import (
    SubstitutionMatrix,
    check_big_main_diag,
    check_symmetric,
    create_costing_mat,
    create_scoring_mat,
    get_max_val,
    load_bundled_matrix,
    read_scoring_mat,
    validate_scoring_mat_keys,
)
from .utils.random_seqs import draw_random_seq, draw_two_random_seqs
from .utils.tokenize import Alphabet

__all__ = [
    "__version__",
    "find_global_alignment",
    "align_pairs",
    "PairResult",
    "BatchRunner",
    "AlignmentResults",
    "alignment_to_cigar",
    "GotohAligner",
    "GotohAlignment",
    "ResolvedScheme",
    "SimpleScoringSettings",
    "SimpleCostingSettings",
    "resolve_scheme",
    "scheme_from_arrays",
    "validate_and_transform_args",
    "scoring_mat_to_costing_mat",
    "costing_mat_to_scoring_mat",
    "final_cost_to_score",
    "final_score_to_cost",
    "prettify_mat",
    "SubstitutionMatrix",
    "Alphabet",
    "read_scoring_mat",
    "load_bundled_matrix",
    "create_scoring_mat",
    "create_costing_mat",
    "check_symmetric",
    "check_big_main_diag",
    "validate_scoring_mat_keys",
    "get_max_val",
    "read_seq_from_fasta",
    "read_first_2_seqs_from_fasta",
    "draw_random_seq",
    "draw_two_random_seqs",
]
