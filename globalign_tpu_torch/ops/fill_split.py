"""Meet-in-the-middle optimal cost — one 2-pair last-rows fill and a join.

The port of ``globalign_tpu/ops/fill_lanes.py:lanes_split_fill_cost`` and
``globalign_tpu/ops/fill_pallas.py:split_fill_cost`` (the same math):
split seq_1 at ``mid = m // 2``; fill the top half (rows 1..mid) forward
and the bottom half (rows m..mid+1) reversed against reversed seq_2, as
one ``fill_cuda.batch_last_rows`` launch with B = 2 (``gotoh_tile`` or
``gotoh_fill``, as ``fill_tile.route`` says); then join across the
middle row in plain torch, as the JAX package does outside its kernels:

    cost = min_{j, L, L'} F_L(mid, j) + G_L'(m - mid, n - j)
                          - go * [L == L' in {Ix, Iy}]

where the correction removes the double-charged open of a gap run that
spans the split (Myers-Miller over the Gotoh recurrence).  F and G are
clamped to BIG/2 before the sum so the sentinels cannot overflow int32.
A single fill of m rows is m serial row steps; the split runs the two
halves side by side in about m/2.
"""

from __future__ import annotations

import torch

from .fill_cuda import batch_last_rows
from .fill_scan import BIG


def split_fill_cost(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
) -> torch.Tensor:
    """Optimal cost of aligning tok_a[1:] with tok_b[1:] (any m, n >= 0).

    Args:
        tok_a / tok_b: (m+1,) / (n+1,) int32 1-origin tokens on the device
            the fill runs on (CUDA: the kernel; CPU: its plain version).
        cost_mat / gap_id / gap_open: the costing scheme.

    Returns a 0-d int32 tensor on that device.
    """
    m = tok_a.shape[0] - 1
    n = tok_b.shape[0] - 1
    mid = m // 2
    mh = m - mid  # the longer half
    go = int(gap_open)
    dev = tok_a.device

    # Halves by device gathers: top = rows 1..mid forward, bottom = rows
    # m..mid+1 reversed; seq_2 forward and reversed.  Entry 0 is unused.
    ks = torch.arange(mh + 1, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    top_a = torch.where(ks <= mid, tok_a[ks.clamp(max=m)], zero)
    bot_a = torch.where(ks >= 1, tok_a[(m + 1 - ks).clamp(0, m)], zero)
    js = torch.arange(n + 1, device=dev)
    rev_b = torch.where(js >= 1, tok_b[(n + 1 - js).clamp(0, n)], zero)
    last = batch_last_rows(
        torch.stack([top_a, bot_a]), torch.stack([tok_b, rev_b]),
        cost_mat, gap_id, go, [mid, mh], [n, n],
    )  # (2, 3, n+1): row mid of the top half, row m - mid of the bottom

    half_big = BIG // 2
    f = last[0].clamp(max=half_big)
    g = last[1].clamp(max=half_big).flip(-1)  # g[:, j] = G[:, n - j]
    # A zero-row half contributes its boundary row, whose corner holds 0 in
    # all three lanes; its Ix / Iy "levels" there are fictitious (no gap
    # run reaches the corner), so mask them lest the gap-continuation
    # correction undercount by gap_open.
    if mid == 0:
        f[1:, 0] = half_big
    if mh == 0:
        g[1:, n] = half_big
    combo = f[:, None, :] + g[None, :, :]  # (L, L', j)
    combo[1, 1] -= go
    combo[2, 2] -= go
    return combo.min()
