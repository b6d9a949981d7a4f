"""The reference package's module layout over the port.

Code written against the reference ``globalign`` package runs on the card
unchanged once its import reads::

    import globalign_tpu_torch.compat as globalign

    globalign.find_global_alignment(seq_1="ACGT", seq_2="AGT")
    from globalign_tpu_torch.compat.start import create_scoring_mat

The submodules ``globaligner``, ``start``, ``conclude`` and ``dp_compat``
keep the reference's function names, signatures and nested-dict matrix
formats (reference: src/globalign/{globaligner,start,conclude}.py), as the
JAX package's ``globalign`` shim does.  Scores and costs are bit-identical
to the reference; alignments are deterministic where the reference
tie-broke at random.

``find_global_alignment`` defaults to ``device="cuda"``: it runs the CUDA
fill kernel and raises when no GPU is present (pass ``device="cpu"`` for
the plain PyTorch engine).  The reference's DP-internal API is shimmed by
the interpreted list-of-lists adapters of :mod:`.dp_compat`, which never
touch the card.  ``cost_ranks_dispatcher`` is deliberately absent: it
exists only to drive the reference's random tie-breaking.
"""

from . import conclude, globaligner, start  # noqa: F401
from .globaligner import find_global_alignment  # noqa: F401
