"""Cost-only fills of a batch of pairs — the batch serving path's fill.

``batch_final3_ragged`` fills every pair of several length buckets in one
call: the counterpart of the JAX package's fused cost chunk
(``globalign_tpu/batch.py:_chunk_costs_jit``), which dispatches a call's
cost buckets together.  ``batch_final3`` (one bucket) mirrors
``globalign_tpu/ops/fill_pallas.py:batch_final3`` and is a thin caller of
it: (B, 3) int32 final lanes (M, Ix, Iy) at (m_true[b], n_true[b]); with
``last_rows=True`` each pair's row m_true[b] instead, (B, 3, N+1), with
the contract of ``fill_cuda.batch_last_rows`` (column 0 is (BIG, BIG,
Iy(m, 0)), columns past n_true[b] are BIG).

Routes, by the tensors' device and the call's shape only:

  * CPU tensors: the plain version, the row scan of ``ops.fill_rows`` pair
    by pair (``fill_cuda._plain``);
  * CUDA tensors, when :func:`plan` picks ``gotoh_batch`` for the buckets
    of at most ``MAX_COLUMNS`` columns: one launch of
    ``csrc/gotoh_batch.cu`` (a warp per pair, the strip state in
    registers) per width class present — W = 4, 8, 16 or 32 columns a
    lane, the narrowest with 32 W >= the pair's n — over every such pair
    of the call, longest first: the counterpart of TPU kernels #8
    (``stacked_uniform_fill_last_rows``) and #7
    (``row_fill_last_rows_batch``);
  * the other CUDA buckets (wider than ``MAX_COLUMNS``, or a table that
    does not fit in shared memory), the wide route: where
    ``fill_tile.route_buckets`` says so, one ``gotoh_tile`` launch over
    all their pairs (``fill_tile.launch_ragged``: tiles of every pair by
    ticket over the whole card, each pair's tokens read where they lie,
    its final3 written to its row of the call's), so the launch takes
    about its longest pair's path; the buckets it leaves (past 8 columns
    a row, or too many tiles for one path-bound launch) one launch a
    bucket by ``fill_cuda``'s route (``fill_cuda.batch_moves(want_moves=
    False)`` / ``fill_cuda.batch_last_rows``: ``gotoh_fill``'s final3 /
    last-row mode, or ``gotoh_tile`` for one or two large pairs).  Nothing
    on this route waits for the card.

No probe and no fallback: a CUDA tensor the chosen kernel cannot take
raises.  ``batch_final3.launches`` counts ``gotoh_batch`` launches;
``batch_final3_ragged.wide_launches`` the wide route's ``gotoh_tile``
launches and ``.wide_pairs`` the pairs they take; the per-bucket routes
count on their own wrappers.

``batch_moves_warp`` launches the moves sibling, ``csrc/gotoh_batch_moves.cu``
(a warp a pair with its move codes), for ``fill_cuda.batch_moves_ragged``,
which routes a traceback call's pairs by the same :func:`plan`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.spans import span
from . import fill_cuda, fill_tile

WARP = 32
WIDTHS = (4, 8, 16, 32)  # the kernel's instances: columns a lane (W)
MAX_COLUMNS = WARP * WIDTHS[-1]  # the width cap: 1024
WARPS = 2  # warps (pairs) a block
MAX_ALPHABET = 256  # tokens are bytes in the kernel's registers
SMEM_OPTIN = 227 * 1024  # shared memory a block may opt in to on sm_90
DESC_WORDS = 8  # int64 words of a pair descriptor (csrc/gotoh_batch.cu)


def width_class(n_cols: int) -> int:
    """W of the narrowest ``gotoh_batch`` instance that holds ``n_cols``
    columns (32 W >= n); ``n_cols`` must not pass ``MAX_COLUMNS``."""
    for width in WIDTHS:
        if n_cols <= WARP * width:
            return width
    raise ValueError(f"{n_cols} columns exceed gotoh_batch's {MAX_COLUMNS}")


def plan(n_cols: int, alphabet: int) -> int | None:
    """W of the ``gotoh_batch`` launch that takes a bucket of ``n_cols``
    columns with an (A, A) table, or None when the bucket goes to
    ``gotoh_fill``: wider than ``MAX_COLUMNS``, an alphabet past
    ``MAX_ALPHABET``, or a table past the shared memory of a block.

    The batch size plays no part: on an H100 ``gotoh_batch`` beats
    ``gotoh_fill`` final3 at every B from 1 to 1024 pairs of 256^2 and
    1024^2, a lone warp a pair included (the crossover sweep of PERF.md
    section 6, run by ``chip_smoke.py`` at commit b226048), so no launch
    of at most ``MAX_COLUMNS`` columns is small enough for
    ``gotoh_fill``."""
    if n_cols > MAX_COLUMNS or alphabet > MAX_ALPHABET:
        return None
    if 4 * alphabet * alphabet > SMEM_OPTIN:
        return None
    return width_class(n_cols)


def _descriptors(tok_a, tok_b, lasts, m_host, n_host, offsets):
    """(P, 8) int64 descriptors of the buckets' pairs: seq_1 / seq_2 /
    last-row addresses (0: no last row), m, n, the last row's stride, the
    final3 row, a pad (csrc/gotoh_batch.cu)."""
    parts = []
    for k, (ta, tb) in enumerate(zip(tok_a, tok_b)):
        batch, m1 = ta.shape
        n1 = tb.shape[1]
        rows = np.arange(batch, dtype=np.int64)
        d = np.zeros((batch, DESC_WORDS), np.int64)
        d[:, 0] = ta.data_ptr() + rows * 4 * m1
        d[:, 1] = tb.data_ptr() + rows * 4 * n1
        if lasts is not None:
            d[:, 2] = lasts[k].data_ptr() + rows * 12 * n1
        d[:, 3] = m_host[k].numpy()
        d[:, 4] = n_host[k].numpy()
        d[:, 5] = n1
        d[:, 6] = offsets[k] + rows
        parts.append(d)
    return np.concatenate(parts)


def batch_final3_ragged(
    tok_a,
    tok_b,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    *,
    last_rows: bool = False,
):
    """Final lanes of every pair of several buckets, one call.

    Args:
        tok_a / tok_b: sequences of (B_k, M_k+1) / (B_k, N_k+1) int32
            contiguous 1-origin tokens (column 0 unused), one a bucket, all
            on the CPU or all on one CUDA device.
        cost_mat: (A, A) int32 contiguous costing matrix on that device.
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: sequences of (B_k,) host-side true lengths.

    Returns (sum B_k, 3) final lanes in bucket order, pairs in their
    bucket's order — or, with ``last_rows``, the list of each bucket's
    (B_k, 3, N_k+1) rows m_true (views of one launch's rows where the wide
    route takes the bucket).
    """
    tok_a, tok_b = list(tok_a), list(tok_b)
    with span("fill.batch"):
        device, lengths = fill_cuda._check_buckets(
            tok_a, tok_b, cost_mat, gap_id, m_true, n_true
        )
        m_host = [m for m, _ in lengths]
        n_host = [n for _, n in lengths]
        offsets = np.concatenate([[0], np.cumsum([ta.shape[0] for ta in tok_a])])
        if device.type == "cuda":
            final3, lasts, rest = _batch_part(
                tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host,
                offsets, last_rows,
            )
    if device.type == "cpu":
        outs = [
            fill_cuda._plain(ta, tb, cost_mat, gap_id, gap_open, mt, nt, None,
                             None, False, last_rows)
            for ta, tb, mt, nt in zip(tok_a, tok_b, m_host, n_host)
        ]
        if last_rows:
            return [last for _, _, last in outs]
        return torch.cat([final3 for final3, _, _ in outs])
    if device.type != "cuda":
        raise ValueError(f"no batch_final3 route for device {device}")
    if not rest:
        return lasts if last_rows else final3

    with span("fill.wide"):
        tiled = [rest[i] for i in fill_tile.route_buckets(
            [(m_host[k].tolist(), n_host[k].tolist()) for k in rest],
            fill_cuda._sms(device.index))]
        if final3 is None and not tiled:  # one bucket on its own route
            out = _gotoh_fill(tok_a[0], tok_b[0], cost_mat, gap_id, gap_open,
                              m_host[0], n_host[0], last_rows)
            return [out] if last_rows else out
        if final3 is None:
            final3 = torch.empty((int(offsets[-1]), 3), dtype=torch.int32,
                                 device=device)
        if tiled:
            batch_final3_ragged.wide_launches += 1
            batch_final3_ragged.wide_pairs += sum(tok_a[k].shape[0]
                                                  for k in tiled)
            out = fill_tile.launch_ragged(
                [tok_a[k] for k in tiled], [tok_b[k] for k in tiled],
                cost_mat, gap_id, gap_open, [m_host[k] for k in tiled],
                [n_host[k] for k in tiled], final3,
                [int(offsets[k]) for k in tiled], last_rows=last_rows,
            )
            for k, last in zip(tiled, out or ()):
                lasts[k] = last
        for k in [k for k in rest if k not in tiled]:
            out = _gotoh_fill(tok_a[k], tok_b[k], cost_mat, gap_id, gap_open,
                              m_host[k], n_host[k], last_rows)
            if last_rows:
                lasts[k] = out
            else:
                final3[int(offsets[k]) : int(offsets[k + 1])] = out
    return lasts if last_rows else final3


def _batch_part(tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host,
                offsets, last_rows):
    """The buckets ``plan`` gives ``gotoh_batch``, launched: (final3, lasts,
    rest) with ``rest`` the buckets left to ``gotoh_fill`` and final3 (the
    rows of every pair, bucket k's from ``offsets[k]``) None where one
    bucket alone is left to it."""
    device = cost_mat.device
    alphabet = cost_mat.shape[0]
    sizes = np.diff(offsets).tolist()
    routes = [plan(tb.shape[1] - 1, alphabet) for tb in tok_b]
    on_batch = [k for k, route in enumerate(routes) if route is not None]
    rest = [k for k, route in enumerate(routes) if route is None]
    lasts = [None] * len(tok_a)
    if len(tok_a) == 1 and rest:
        return None, lasts, rest

    final3 = torch.empty((int(offsets[-1]), 3), dtype=torch.int32, device=device)
    if on_batch:
        lasts_b = (
            [torch.empty((sizes[k], 3, tok_b[k].shape[1]), dtype=torch.int32,
                         device=device) for k in on_batch]
            if last_rows else None
        )
        desc = _descriptors(
            [tok_a[k] for k in on_batch], [tok_b[k] for k in on_batch], lasts_b,
            [m_host[k] for k in on_batch], [n_host[k] for k in on_batch],
            [int(offsets[k]) for k in on_batch],
        )
        _gotoh_batch(desc, cost_mat, gap_id, gap_open, final3, last_rows)
        if last_rows:
            for k, last in zip(on_batch, lasts_b):
                lasts[k] = last
    return final3, lasts, rest


def _gotoh_fill(tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host,
                last_rows):
    """One bucket on ``fill_cuda``'s route: ``gotoh_fill``'s final3 /
    last-row mode, or ``gotoh_tile`` for one or two large pairs."""
    if last_rows:
        return fill_cuda.batch_last_rows(
            tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host
        )
    final3, _ = fill_cuda.batch_moves(
        tok_a, tok_b, cost_mat, gap_id, gap_open, m_host, n_host,
        want_moves=False,
    )
    return final3


def _gotoh_batch(desc: np.ndarray, cost_mat: torch.Tensor, gap_id: int,
                 gap_open: int, final3: torch.Tensor, last_rows: bool) -> None:
    """Launch ``gotoh_batch`` over the pairs of ``desc`` ((P, 8) int64
    host descriptors, each pair's n <= ``MAX_COLUMNS``): one launch per
    width class present, pairs longest (m * n) first, final3 into the rows
    the descriptors name (and the last rows through their addresses, with
    ``last_rows``).  Every launch counts on ``batch_final3.launches``; a
    refused or failed launch raises."""
    device = final3.device
    caps = WARP * np.array(WIDTHS)
    widths = np.array(WIDTHS)[np.searchsorted(caps, desc[:, 4])]
    order = np.lexsort((-(desc[:, 3] * desc[:, 4]), widths))
    desc, widths = np.ascontiguousarray(desc[order]), widths[order]
    starts = np.flatnonzero(np.diff(widths, prepend=-1))
    ends = np.append(starts[1:], len(widths))
    from ..utils import cuda_build

    lib = cuda_build.load()
    desc_dev = torch.from_numpy(desc).pin_memory().to(device, non_blocking=True)
    row_bytes = DESC_WORDS * 8
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo, hi in zip(starts.tolist(), ends.tolist()):
            batch_final3.launches += 1
            err = lib.gotoh_batch_launch(
                desc_dev.data_ptr() + lo * row_bytes, hi - lo,
                cost_mat.data_ptr(), cost_mat.shape[0], int(gap_id),
                int(gap_open), final3.data_ptr(), int(last_rows),
                int(widths[lo]), WARPS, stream,
            )
            if err != 0:
                msg = lib.gotoh_batch_error_string(err).decode()
                raise RuntimeError(
                    f"gotoh_batch launch failed: CUDA error {err} ({msg})"
                )


def batch_moves_warp(desc: torch.Tensor, lo: int, count: int, width: int,
                     cost_mat: torch.Tensor, gap_id: int, gap_open: int,
                     final3: torch.Tensor, codes: torch.Tensor) -> None:
    """Launch ``gotoh_batch_moves`` over the ``count`` pairs of ``desc``
    ((P, 8) int64 ragged descriptors on the card, ``fill_cuda.RaggedMoves``'
    layout) from row ``lo``, all of width class ``width``: final3 into the
    rows and codes at the offsets (multiples of ``fill_cuda.ALIGN``, row
    strides ``fill_cuda.ragged_stride``) that the descriptors name.  One
    launch, counted on ``batch_moves_warp.launches``; a refused or failed
    launch raises.  ``fill_cuda.batch_moves_ragged`` is the wrapper that
    checks the descriptors and runs the plain version for CPU tensors."""
    from ..utils import cuda_build

    lib = cuda_build.load()
    device = final3.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        batch_moves_warp.launches += 1
        err = lib.gotoh_batch_moves_launch(
            desc.data_ptr() + lo * DESC_WORDS * 8, count, cost_mat.data_ptr(),
            cost_mat.shape[0], int(gap_id), int(gap_open), final3.data_ptr(),
            codes.data_ptr(), int(width), WARPS, stream,
        )
    if err != 0:
        msg = lib.gotoh_batch_moves_error_string(err).decode()
        raise RuntimeError(f"gotoh_batch_moves launch failed: CUDA error {err} "
                           f"({msg})")


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
    """Final lanes (B, 3) — or, with ``last_rows``, rows m_true (B, 3, N+1)
    — of one bucket: :func:`batch_final3_ragged` on it alone.

    Args:
        tok_a / tok_b: (B, M+1) / (B, N+1) int32 contiguous 1-origin tokens
            (column 0 unused), on the CPU or on a CUDA device.
        cost_mat: (A, A) int32 contiguous costing matrix on the same device.
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: (B,) true lengths, host-side.
    """
    out = batch_final3_ragged(
        [tok_a], [tok_b], cost_mat, gap_id, gap_open, [m_true], [n_true],
        last_rows=last_rows,
    )
    return out[0] if last_rows else out


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
    to ``MAX_COLUMNS`` columns (a launch a width class), one ``gotoh_fill``
    final3 launch past it (:func:`plan`).  Each set
    equals :func:`batch_final3` on that set alone.

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
batch_final3_ragged.wide_launches = 0
batch_final3_ragged.wide_pairs = 0
batch_moves_warp.launches = 0
