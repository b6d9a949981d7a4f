"""Batched Gotoh fill with move codes — the CUDA kernel and its plain version.

``batch_moves`` is the counterpart of ``globalign_tpu/ops/fill_pallas.py:
batch_moves``: final3 and row-major move codes for B pairs.  On CUDA
tensors it launches the hand-written kernel ``csrc/gotoh_fill.cu`` (one
block per pair; see the note at the head of that file), on CPU tensors it
runs the plain version, the row scan of ``ops.fill_rows``, pair by pair.
There is no other route: a CUDA tensor that the kernel cannot take raises.

Unlike the TPU path there is no skewed layout and no host unskew
(``fill_lanes.lanes_moves_to_row``): the kernel writes ``moves[b, i, j]``
directly.  Codes are defined at real cells 1 <= i <= m_true[b],
1 <= j <= n_true[b]; every other byte is 0 on both routes.
"""

from __future__ import annotations

import torch

from .fill_rows import row_fill

MAX_THREADS = 1024  # the kernel's __launch_bounds__


def _plan(n_cols: int) -> tuple[int, int]:
    """(threads, W): the block size and the widest strip for N columns."""
    width = max(1, -(-n_cols // MAX_THREADS))
    strips = max(1, -(-n_cols // width))
    return 32 * -(-strips // 32), width


def _lengths(lengths, batch: int, cap: int, name: str) -> torch.Tensor:
    out = torch.as_tensor(lengths, dtype=torch.int32)
    if out.device.type != "cpu":
        raise ValueError(f"{name} must be host-side (CPU tensor, list or array)")
    if out.shape != (batch,):
        raise ValueError(f"{name} must have shape ({batch},), got {tuple(out.shape)}")
    if bool((out < 0).any()) or bool((out > cap).any()):
        raise ValueError(f"{name} must lie in [0, {cap}], got {out.tolist()}")
    return out


def _plain(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, want_moves):
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    final3 = torch.empty((batch, 3), dtype=torch.int32)
    moves = torch.zeros((batch, m1, n1), dtype=torch.uint8) if want_moves else None
    for b in range(batch):
        m, n = int(m_true[b]), int(n_true[b])
        res = row_fill(
            tok_a[b, : m + 1], tok_b[b, : n + 1], cost_mat, gap_id, gap_open,
            want_moves=want_moves,
        )
        final3[b] = res.final3
        if want_moves:
            moves[b, 1 : m + 1, 1 : n + 1] = res.moves[1:, 1:]
    return final3, moves


def batch_moves(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    *,
    want_moves: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fill B pairs: ``(final3 (B, 3) int32, moves (B, M+1, N+1) uint8)``.

    Args:
        tok_a / tok_b: (B, M+1) / (B, N+1) int32 contiguous 1-origin tokens
            (column 0 unused), on the CPU or on a CUDA device.
        cost_mat: (A, A) int32 contiguous costing matrix on the same device.
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: (B,) true lengths, host-side.
        want_moves: False skips the codes (``moves`` is None) — the cost-only
            mode used by ``GotohAligner.cost``.

    ``batch_moves.launches`` counts kernel launches.
    """
    if tok_a.dim() != 2 or tok_b.dim() != 2 or tok_a.shape[0] != tok_b.shape[0]:
        raise ValueError("tok_a / tok_b must be (B, M+1) / (B, N+1)")
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    if batch < 1 or m1 < 1 or n1 < 1:
        raise ValueError("empty token buffers")
    num = cost_mat.shape[0]
    if cost_mat.dim() != 2 or cost_mat.shape[1] != num:
        raise ValueError("cost_mat must be square (A, A)")
    if not 0 <= int(gap_id) < num:
        raise ValueError(f"gap_id {gap_id} outside the alphabet of {num}")
    for name, x in (("tok_a", tok_a), ("tok_b", tok_b), ("cost_mat", cost_mat)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != tok_a.device:
            raise ValueError(f"{name} is on {x.device}, tok_a on {tok_a.device}")
    m_true = _lengths(m_true, batch, m1 - 1, "m_true")
    n_true = _lengths(n_true, batch, n1 - 1, "n_true")

    device = tok_a.device
    if device.type == "cpu":
        return _plain(
            tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, want_moves
        )
    if device.type != "cuda":
        raise ValueError(f"no gotoh_fill route for device {device}")

    from ..utils import cuda_build

    lib = cuda_build.load()
    threads, width = _plan(n1 - 1)
    final3 = torch.empty((batch, 3), dtype=torch.int32, device=device)
    moves = (
        torch.empty((batch, m1, n1), dtype=torch.uint8, device=device)
        if want_moves
        else None
    )
    scratch = torch.empty(
        (batch, 4, width * threads), dtype=torch.int32, device=device
    )
    m_dev = m_true.pin_memory().to(device, non_blocking=True)
    n_dev = n_true.pin_memory().to(device, non_blocking=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        batch_moves.launches += 1
        err = lib.gotoh_fill_launch(
            tok_a.data_ptr(), tok_b.data_ptr(), cost_mat.data_ptr(),
            m_dev.data_ptr(), n_dev.data_ptr(), final3.data_ptr(),
            moves.data_ptr() if want_moves else None, scratch.data_ptr(),
            batch, m1 - 1, n1 - 1, num, int(gap_id), int(gap_open),
            threads, width, stream,
        )
    if err != 0:
        msg = lib.gotoh_fill_error_string(err).decode()
        raise RuntimeError(f"gotoh_fill launch failed: CUDA error {err} ({msg})")
    return final3, moves


batch_moves.launches = 0
