"""Cost-only fills of a batch of pairs — the batch serving path's fill.

``batch_final3`` mirrors ``globalign_tpu/ops/fill_pallas.py:batch_final3``:
(B, 3) int32 final lanes (M, Ix, Iy) at (m_true[b], n_true[b]); with
``last_rows=True`` it returns each pair's row m_true[b] instead, (B, 3,
N+1), with the contract of ``fill_cuda.batch_last_rows`` (column 0 is
(BIG, BIG, Iy(m, 0)), columns past n_true[b] are BIG).

Routes, by the tensors' device and the bucket's shape only:

  * CPU tensors: the plain version, the row scan of ``ops.fill_rows`` pair
    by pair (``fill_cuda._plain``);
  * CUDA tensors whose width and table fit ``gotoh_batch``'s shared-memory
    plan (:func:`plan`): one launch of ``csrc/gotoh_batch.cu``, a warp per
    pair — the counterpart of TPU kernels #8
    (``stacked_uniform_fill_last_rows``) and #7
    (``row_fill_last_rows_batch``);
  * wider CUDA buckets: ``gotoh_fill``'s final3 / last-row mode
    (``fill_cuda.batch_moves(want_moves=False)`` /
    ``fill_cuda.batch_last_rows``), a block per pair — #7's grid-per-pair
    form for long pairs.

No probe and no fallback: a CUDA tensor the chosen kernel cannot take
raises.  ``batch_final3.launches`` counts ``gotoh_batch`` launches; the
``gotoh_fill`` route counts on its own wrappers.
"""

from __future__ import annotations

import torch

from . import fill_cuda

WARP = 32
MAX_COLUMNS = 4096  # the width cap: W = 128 columns a lane (csrc note)
MAX_WARPS = 4  # warps (pairs) a block
SMEM_OPTIN = 227 * 1024  # shared memory a block may opt in to on sm_90
COLUMN_BYTES = 13  # a strip column: M, Ix, Iy int32 + a token byte


def plan(batch: int, n_cols: int, alphabet: int, sms: int) -> tuple[int, int] | None:
    """``(warps a block, W)`` for a ``gotoh_batch`` launch over B pairs of
    N columns with an (A, A) table on a card of ``sms`` SMs, or None when
    the bucket goes to ``gotoh_fill`` (wider than ``MAX_COLUMNS``, or a
    table that does not fit in shared memory beside one warp's state)."""
    width = max(1, -(-n_cols // WARP))
    if n_cols > MAX_COLUMNS or alphabet > 256:
        return None
    table = 4 * alphabet * alphabet
    per_warp = COLUMN_BYTES * WARP * width
    warps = min(MAX_WARPS, max(1, batch // max(1, sms)))
    while warps > 0 and table + warps * per_warp > SMEM_OPTIN:
        warps -= 1
    return (warps, width) if warps else None


def batch_final3(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    *,
    last_rows: bool = False,
) -> torch.Tensor:
    """Final lanes (B, 3) — or, with ``last_rows``, rows m_true (B, 3, N+1).

    Args:
        tok_a / tok_b: (B, M+1) / (B, N+1) int32 contiguous 1-origin tokens
            (column 0 unused), on the CPU or on a CUDA device.
        cost_mat: (A, A) int32 contiguous costing matrix on the same device.
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: (B,) true lengths, host-side.
    """
    m_host, n_host = fill_cuda._check(
        tok_a, tok_b, cost_mat, gap_id, m_true, n_true, None, None
    )
    device = tok_a.device
    if device.type == "cpu":
        final3, _, last = fill_cuda._plain(
            tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host, None,
            None, False, last_rows,
        )
        return last if last_rows else final3
    if device.type != "cuda":
        raise ValueError(f"no batch_final3 route for device {device}")

    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    launch = plan(batch, n1 - 1, cost_mat.shape[0], sms)
    if launch is None:  # wider than the cap: a block per pair
        if last_rows:
            return fill_cuda.batch_last_rows(
                tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host
            )
        final3, _ = fill_cuda.batch_moves(
            tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host,
            want_moves=False,
        )
        return final3

    from ..utils import cuda_build

    lib = cuda_build.load()
    warps, width = launch
    final3 = torch.empty((batch, 3), dtype=torch.int32, device=device)
    last = (
        torch.empty((batch, 3, n1), dtype=torch.int32, device=device)
        if last_rows
        else None
    )
    m_dev = m_host.pin_memory().to(device, non_blocking=True)
    n_dev = n_host.pin_memory().to(device, non_blocking=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        batch_final3.launches += 1
        err = lib.gotoh_batch_launch(
            tok_a.data_ptr(), tok_b.data_ptr(), cost_mat.data_ptr(),
            m_dev.data_ptr(), n_dev.data_ptr(), final3.data_ptr(),
            None if last is None else last.data_ptr(),
            batch, m1 - 1, n1 - 1, cost_mat.shape[0], int(gap_id),
            int(gap_open), warps, width, stream,
        )
    if err != 0:
        msg = lib.gotoh_batch_error_string(err).decode()
        raise RuntimeError(f"gotoh_batch launch failed: CUDA error {err} ({msg})")
    return last if last_rows else final3


def batch_final3_dual(
    tok_a2: torch.Tensor,
    tok_b2: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m2,
    n2,
) -> torch.Tensor:
    """Final lanes (2, B, 3) of two same-shape sets of B pairs, one launch.

    The counterpart of ``globalign_tpu/ops/fill_lanes.py``'s
    ``lanes_batch_final3_dual`` (uniform schemes, reached here through the
    scheme's costing matrix) and ``lanes_general_final3_dual`` (any
    matrix): TPU kernel ``_make_lane_kernel(npar=2)``, which interleaved
    the two sets' DP chains in one VPU instruction stream.  On the card,
    warps of independent pairs already interleave on each SM's schedulers,
    so the set axis folds into the batch axis and the two sets are one
    :func:`batch_final3` call over 2B pairs: one ``gotoh_batch`` launch up
    to ``MAX_COLUMNS`` columns, one ``gotoh_fill`` final3 launch above.
    Each set equals :func:`batch_final3` on that set alone.

    Args:
        tok_a2 / tok_b2: (2, B, M+1) / (2, B, N+1) int32 contiguous
            1-origin tokens, on the CPU or on a CUDA device.
        cost_mat / gap_id / gap_open: the costing scheme, as in
            :func:`batch_final3`.
        m2 / n2: (2, B) true lengths, host-side.

    The launch counts on ``batch_final3.launches`` (``gotoh_batch``) or
    ``fill_cuda.batch_moves.launches`` (``gotoh_fill``).
    """
    if tok_a2.dim() != 3 or tok_b2.dim() != 3 or tok_a2.shape[0] != 2 or (
        tok_b2.shape[:2] != tok_a2.shape[:2]
    ):
        raise ValueError("tok_a2 / tok_b2 must be (2, B, M+1) / (2, B, N+1)")
    if not (tok_a2.is_contiguous() and tok_b2.is_contiguous()):
        raise ValueError("tok_a2 / tok_b2 must be contiguous")
    sets, batch = tok_a2.shape[:2]
    lengths = []
    for name, x in (("m2", m2), ("n2", n2)):
        x = torch.as_tensor(x, dtype=torch.int32)
        if x.shape != (sets, batch):
            raise ValueError(
                f"{name} must have shape ({sets}, {batch}), got {tuple(x.shape)}"
            )
        lengths.append(x.reshape(-1))
    final3 = batch_final3(
        tok_a2.reshape(sets * batch, -1), tok_b2.reshape(sets * batch, -1),
        cost_mat, gap_id, gap_open, *lengths,
    )
    return final3.reshape(sets, batch, 3)


batch_final3.launches = 0
