"""Row-parallel Gotoh DP fill via a min-plus prefix scan, in PyTorch.

The port of ``globalign_tpu/ops/fill_rows.py:row_fill_impl``: the same
recurrence, operation for operation, so every cell — codes included — is
bit-identical to the JAX row scan.  It is the plain version of the CUDA
kernel in ``ops.fill_cuda`` and the port's CPU engine.

Within row ``i`` of the Gotoh cost-space recurrence

    M [i,j] = min(M, Ix, Iy)[i-1,j-1]           + sub(a_i, b_j)
    Iy[i,j] = min(M+go, Ix+go, Iy)[i-1,j]       + icost(a_i)
    Ix[i,j] = min(M+go, Ix, Iy+go)[i,j-1]       + dcost(b_j)

the M and Iy lanes depend only on row ``i-1`` and vectorize over all ``j``.
The Ix lane's horizontal dependency is a min-plus linear recurrence whose
closed form is a prefix minimum: with ``D[j] = d_1 + ... + d_j`` and
``H[j] = min(M[i,j], Iy[i,j]) + go``,

    Ix[i,j] = D[j] + min_{j' < j} (H[j'] - D[j'])

computed exactly in int32 by one ``torch.cummin``.  Move codes come from
exact integer equalities against each candidate, tie priority M > Ix > Iy.
Moves are row-major: ``moves[i, j]`` is the packed code of cell (i, j).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fill_scan import BIG, default_boundary


class RowFillResult(NamedTuple):
    """Result of a row-scan fill.

    Attributes:
        final3: (3,) int32 — (M, Ix, Iy) at cell (m_true, n_true); its min is
            the optimal alignment cost (reference globaligner.py:425).
        moves: (m+1, n+1) uint8 row-major packed argmin codes, or None.
            Bits 0-1 = level-M predecessor, 2-3 = level-Ix, 4-5 = level-Iy
            (0=M, 1=Ix, 2=Iy).  Row 0 is all zeros (boundary).
        planes: (3, m+1, n+1) int32 dense cost planes, or None (debug).
        last3: (3, n+1) int32 — the DP lanes of the last computed row ``m``.
    """

    final3: torch.Tensor
    moves: torch.Tensor | None
    planes: torch.Tensor | None
    last3: torch.Tensor


def _shift_right_big(x: torch.Tensor) -> torch.Tensor:
    """out[j] = x[j-1]; out[0] = BIG."""
    return torch.cat([x.new_full((1,), BIG), x[:-1]])


def _code(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """0 where ``first``, else 1 where ``second``, else 2 (uint8)."""
    return torch.where(first, 0, torch.where(second, 1, 2)).to(torch.uint8)


def row_fill(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true: int | None = None,
    n_true: int | None = None,
    *,
    want_moves: bool = True,
    want_planes: bool = False,
) -> RowFillResult:
    """Fill the Gotoh DP matrix row by row (see module docstring).

    Args:
        tok_a / tok_b: (m+1,) / (n+1,) int32 1-origin tokens, on the device
            the fill runs on.
        cost_mat: (A, A) int32 costing matrix (gap symbol included).
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: true lengths for padded buffers (default: the
            buffer lengths); ``final3`` is read at cell (m_true, n_true).
    """
    m = tok_a.shape[0] - 1
    n = tok_b.shape[0] - 1
    m_true = m if m_true is None else int(m_true)
    n_true = n if n_true is None else int(n_true)
    if not (0 <= m_true <= m and 0 <= n_true <= n):
        raise ValueError(
            f"true lengths ({m_true}, {n_true}) outside the buffers ({m}, {n})"
        )
    gap_id = int(gap_id)
    go = int(gap_open)
    cost_mat = cost_mat.to(torch.int32)

    row0, col0 = default_boundary(tok_a, tok_b, cost_mat, gap_id, go)

    # One-time setup gathers outside the row loop: per-character
    # substitution rows over seq_2, horizontal gap steps + their prefix sum.
    # Row tokens, vertical gap steps and the column-0 Iy boundary go to the
    # host once, so the loop indexes with Python ints (no device syncs).
    subrows = cost_mat[:, tok_b]  # (A, n+1): subrows[c, j] = cost(c, b_j)
    dsteps = cost_mat[gap_id, tok_b].clone()
    dsteps[0] = 0  # (n+1,) dcost(b_j)
    dprefix = torch.cumsum(dsteps, 0, dtype=torch.int32)  # D[j]
    a_host = tok_a.tolist()
    ic_host = cost_mat[tok_a, gap_id].tolist()  # icost(a_i)
    y_bound = col0[2].tolist()

    moves = planes = None
    if want_moves:
        moves = torch.zeros((m + 1, n + 1), dtype=torch.uint8, device=tok_a.device)
    if want_planes:
        planes = torch.empty(
            (3, m + 1, n + 1), dtype=torch.int32, device=tok_a.device
        )
        planes[:, 0] = row0
    final3 = row0[:, n_true].clone() if m_true == 0 else None

    mp, xp, yp = row0[0], row0[1], row0[2]
    for i in range(1, m + 1):
        sub_row = subrows[a_host[i]]  # (n+1,) cost(a_i, b_j)

        # Diagonal + vertical lanes: fully vectorized over j.
        mp_s = _shift_right_big(mp)
        xp_s = _shift_right_big(xp)
        yp_s = _shift_right_big(yp)
        best_prev_s = torch.minimum(torch.minimum(mp_s, xp_s), yp_s)
        mc = torch.clamp_max(best_prev_s + sub_row, BIG)
        vy = torch.minimum(torch.minimum(mp + go, xp + go), yp)
        yc = torch.clamp_max(vy + ic_host[i], BIG)

        # Column-0 boundary before H so that Ix[i,1] sees the boundary cell.
        mc[0] = BIG
        yc[0] = y_bound[i]

        # Horizontal lane via exclusive prefix-min of H - D (exact in int32);
        # the matrix edge floors the prefix at BIG (Ix unreachable there).
        h = torch.minimum(mc, yc) + go
        p = h - dprefix
        ep = torch.clamp_max(torch.cummin(_shift_right_big(p), 0).values, BIG)
        xc = torch.clamp_max(dprefix + ep, BIG)
        xc[0] = BIG

        if i == m_true:
            final3 = torch.stack([mc[n_true], xc[n_true], yc[n_true]])
        if want_moves:
            # Argmin provenance by exact equality, tie priority M > Ix > Iy.
            code_m = _code(mp_s == best_prev_s, xp_s == best_prev_s)
            code_y = _code(mp + go == vy, xp + go == vy)
            # Reference candidate order for Ix is (M+go, Ix, Iy+go)
            # (globaligner.py:342-347): M wins ties, then Ix, then Iy.
            mc_s = _shift_right_big(mc)
            xc_s = _shift_right_big(xc)
            code_x = _code(xc == mc_s + go + dsteps, xc == xc_s + dsteps)
            moves[i] = code_m + 4 * code_x + 16 * code_y
        if want_planes:
            planes[:, i] = torch.stack([mc, xc, yc])
        mp, xp, yp = mc, xc, yc

    return RowFillResult(
        final3=final3,
        moves=moves,
        planes=planes,
        last3=torch.stack([mp, xp, yp]),
    )
