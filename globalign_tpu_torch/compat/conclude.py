"""``globalign.conclude`` over the port (reference conclude.py)."""

from ..ops.transforms import (  # noqa: F401
    final_cost_to_score,
    final_score_to_cost,
)
from ..results import (  # noqa: F401
    AlignmentResults,
    prettify_mat,
    print_nested_list_aligned,
)
