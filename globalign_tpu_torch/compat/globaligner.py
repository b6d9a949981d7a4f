"""``globalign.globaligner`` over the port (reference globaligner.py:23-821).

``find_global_alignment`` and ``main`` are the port's own entry points, so
they run on the card by default (``device="cuda"``, ``--device cuda``) and
raise when no GPU is present; pass ``device="cpu"`` / ``--device cpu`` for
the plain PyTorch engine.  Unlike :mod:`globalign_tpu_torch.compat.start`'s
validation they keep the port's lifted input cap.

The DP-internal symbols (``make_dp_array`` .. ``take_*``) are
list-of-lists compatibility adapters — see
:mod:`globalign_tpu_torch.compat.dp_compat` for their contract and
documented deterministic divergences."""

from ..api import find_global_alignment  # noqa: F401
from ..cli import main  # noqa: F401
from .dp_compat import (  # noqa: F401
    dp_array_backward,
    dp_array_forward,
    get_next_best_costs,
    make_dp_array,
    take_gap_in_seq_1,
    take_gap_in_seq_2,
    take_match,
    take_mismatch,
)
