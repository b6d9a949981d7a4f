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


batch_final3.launches = 0
