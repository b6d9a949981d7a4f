"""DP boundary of the Gotoh fill, in PyTorch.

The port of ``globalign_tpu/ops/fill_scan.py``'s ``BIG`` sentinel and
``default_boundary`` (the reference's ``make_dp_array``,
globaligner.py:756-821).  The anti-diagonal fill of that module is not
ported: the row scan (``ops.fill_rows``) is the plain engine and the CUDA
kernel (``ops.fill_cuda``) the device one.
"""

from __future__ import annotations

import torch

# Large sentinel standing in for +inf, the array analog of the reference's
# ``big_num = (max_cost + 1) * max(m, n)`` trick (globaligner.py:774-777).
# Chosen so that BIG plus any accumulated step costs stays far below the
# int32 overflow point for any practical sequence length.
BIG = 1 << 30


def default_boundary(
    tok_a_ext: torch.Tensor,
    tok_b_ext: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard DP boundary rows (reference ``make_dp_array``, globaligner.py:756-821).

    Returns:
        row0: (3, n+1) int32 — dp[0][j]; level Ix accumulates
            ``gap_open + sum dcost(b_1..b_j)``, levels M/Iy are BIG except
            dp[0][0] = (0, 0, 0).
        col0: (3, m+1) int32 — dp[i][0]; level Iy accumulates
            ``gap_open + sum icost(a_1..a_i)``.
    """
    n1 = tok_b_ext.shape[0]
    m1 = tok_a_ext.shape[0]
    dsteps = cost_mat[gap_id, tok_b_ext].clone()  # (n+1,) dcost(b_j)
    isteps = cost_mat[tok_a_ext, gap_id].clone()  # (m+1,)
    dsteps[0] = 0
    isteps[0] = 0

    ix_row = gap_open + torch.cumsum(dsteps, 0, dtype=torch.int32)
    iy_col = gap_open + torch.cumsum(isteps, 0, dtype=torch.int32)

    big_row = torch.full((n1,), BIG, dtype=torch.int32, device=cost_mat.device)
    big_col = torch.full((m1,), BIG, dtype=torch.int32, device=cost_mat.device)
    row0 = torch.stack([big_row, ix_row, big_row])
    col0 = torch.stack([big_col, big_col, iy_col])
    row0[:, 0] = 0  # dp[0][0] = (0, 0, 0)
    col0[:, 0] = 0
    return row0, col0
