"""Linear-space traceback: row checkpoints + block replay, in PyTorch.

The port of ``globalign_tpu/ops/linear_tb.py`` (``align_blocked``,
``_walk_block_impl``; its ``assemble_from_tapes`` is ``render_walk``).  A
full traceback keeps (m+1)(n+1) bytes of move codes; past the aligner's
moves budget this module aligns in O(n * (m/K + K)) device memory
instead:

1. **Checkpoint pass** — one fill of the whole DP that keeps the last row
   of each block of K rows, (3, n+1) a block
   (``fill_tile.checkpoint_rows``: one ``gotoh_tile`` launch on a card,
   where the JAX package fills a block a call).
2. **Replay pass** — from (m, n) upward, block by block (last block
   first): re-fill the block with move codes (``fill_cuda.batch_moves``,
   same seeds), then walk them where they lie (``walk_block``), which
   writes an op tape and hands its exit column and level to the next
   block's walk as device tensors.

With ``mesh=`` (a ``parallel.Mesh`` of more than one rank, and at least as
many columns as ranks) the checkpoint pass is column-sharded
(``parallel.seqpar.ShardedCheckpointFill``): each block's last row is
filled strip by strip across the ranks and all-gathered, so every rank
holds every checkpoint row and replays on its own device; every rank
returns the same alignment.

Nothing syncs with the host between the first fill and the fetch of the
tapes; the host then rebuilds the strings from the tapes alone
(``render_walk``, the renderer of the full-matrix ``align`` too).  Total
fill work is 2x a plain fill; the path is bit-identical to the
full-matrix traceback (same codes, tie order M > Ix > Iy).

Routing is by device only: on CUDA tensors the kernels (``gotoh_tile``
for the checkpoint pass; the replays as ``fill_cuda.batch_moves`` routes
them, to ``gotoh_tile`` or ``gotoh_fill``; ``walk_block``), on CPU tensors
their plain versions; anything else raises.
Unlike the JAX module there is no backend ladder, no probe and no padding
of n: the kernels take run-time lengths.

``walk_ragged`` is the port of ``lanes_mega_walk``: one walk over the codes
of every pair of a ragged moves fill (``fill_cuda.batch_moves_ragged``), a
traceback ``align_pairs`` call's buckets together.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.spans import span
from .fill_cuda import RaggedMoves, batch_moves
from .fill_tile import checkpoint_rows
from .fill_scan import default_boundary
from .traceback import (
    GAP_CHAR,
    GAP_GLYPH,
    MATCH_GLYPH,
    MISMATCH_GLYPH,
    Traceback,
)

DEFAULT_BLOCK_ROWS = 512

# Adaptive block sizing cap: each replay block materializes (K+1) x (n+1)
# move bytes on the device.  Growing K until one block's codes reach this
# budget keeps the number of blocks (fills and walk launches) small at a
# bounded memory cost.
DEFAULT_BLOCK_MOVES_BYTES = 64 * 1024 * 1024

# Backward-walk move ops (the per-step output of the walk; the host
# rebuilds the aligned strings from these alone).
OP_DIAG = 0  # consume one char of each sequence
OP_LEFT = 1  # gap in seq_1 (consume seq_2[j-1])
OP_UP = 2  # gap in seq_2 (consume seq_1[i-1])


def _walk_steps(codes, base, ld, i, j, level, tape):
    """One walk over flat codes (row i of the pair at ``codes[base + i *
    ld]``) from (i, j) in ``level`` up to row 0, its ops into ``tape``;
    returns (steps, j, level) where it left the codes."""
    t = 0
    while i > 0:
        if j == 0:
            op = OP_UP
        else:
            code = int(codes[base + i * ld + j])
            op = (OP_DIAG, OP_LEFT, OP_UP)[level]
            level = (code >> (2 * level)) & 3
        tape[t] = op
        t += 1
        i -= op != OP_LEFT
        j -= op != OP_UP
    return t, j, level


def _walk_plain(moves, i_entry, j_entry, level_entry):
    """The walk kernel's plain version, over CPU tensors (Python loop)."""
    batch, k1, n1 = moves.shape
    length = k1 - 1 + n1 - 1
    flat = moves.numpy().reshape(-1)
    ops = np.zeros((batch, length), np.uint8)
    count = np.zeros(batch, np.int32)
    j_exit = np.zeros(batch, np.int32)
    level_exit = np.zeros(batch, np.int32)
    for b in range(batch):
        count[b], j_exit[b], level_exit[b] = _walk_steps(
            flat, b * k1 * n1, n1, int(i_entry[b]), int(j_entry[b]),
            int(level_entry[b]), ops[b],
        )
    return tuple(
        torch.from_numpy(x) for x in (ops, count, j_exit, level_exit)
    )


def walk_block(
    moves: torch.Tensor,
    i_entry,
    j_entry: torch.Tensor,
    level_entry: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk B pairs' move codes from row ``i_entry`` up to row 0.

    Args:
        moves: (B, K+1, N+1) uint8 row-major codes (``batch_moves``).
        i_entry: (B,) host-side start rows in [0, K].
        j_entry / level_entry: (B,) int32 start columns and levels, on the
            moves' device — for a chain of blocks, the previous walk's
            ``j_exit`` / ``level_exit``.

    Returns ``(ops (B, K+N) uint8, count (B,), j_exit (B,), level_exit
    (B,))``, int32 on the moves' device; ops past ``count`` are 0.  Column 0
    forces up-moves without reading a code; the walk stops at row 0 and
    leaves the row-0 left moves to the caller (``render_walk``).

    On CUDA tensors one launch of ``csrc/walk_block.cu`` (a warp a pair, its
    codes staged in shared memory), on CPU tensors the plain walk.
    ``walk_block.launches`` counts kernel launches.
    """
    if moves.dim() != 3 or moves.dtype != torch.uint8:
        raise ValueError("moves must be (B, K+1, N+1) uint8")
    batch, k1, n1 = moves.shape
    i_entry = torch.as_tensor(i_entry, dtype=torch.int32)
    if i_entry.device.type != "cpu" or i_entry.shape != (batch,):
        raise ValueError(f"i_entry must be host-side with shape ({batch},)")
    if bool((i_entry < 0).any()) or bool((i_entry > k1 - 1).any()):
        raise ValueError(f"i_entry must lie in [0, {k1 - 1}]")
    for name, x in (("j_entry", j_entry), ("level_entry", level_entry)):
        if x.dtype != torch.int32 or x.shape != (batch,):
            raise ValueError(f"{name} must be ({batch},) int32")
        if x.device != moves.device:
            raise ValueError(f"{name} is on {x.device}, moves on {moves.device}")
    if not moves.is_contiguous():
        raise ValueError("moves must be contiguous")
    device = moves.device
    if device.type == "cpu":
        return _walk_plain(moves, i_entry, j_entry, level_entry)
    if device.type != "cuda":
        raise ValueError(f"no walk_block route for device {device}")

    from ..utils import cuda_build

    lib = cuda_build.load()
    length = k1 - 1 + n1 - 1
    ops = torch.zeros((batch, length), dtype=torch.uint8, device=device)
    count, j_exit, level_exit = (
        torch.empty((batch,), dtype=torch.int32, device=device)
        for _ in range(3)
    )
    i_dev = i_entry.pin_memory().to(device, non_blocking=True)
    j_entry = j_entry.contiguous()
    level_entry = level_entry.contiguous()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        walk_block.launches += 1
        err = lib.walk_block_launch(
            moves.data_ptr(), i_dev.data_ptr(), j_entry.data_ptr(),
            level_entry.data_ptr(), ops.data_ptr(), count.data_ptr(),
            j_exit.data_ptr(), level_exit.data_ptr(),
            batch, k1 - 1, n1 - 1, length, stream,
        )
    if err != 0:
        msg = lib.walk_block_error_string(err).decode()
        raise RuntimeError(f"walk_block launch failed: CUDA error {err} ({msg})")
    return ops, count, j_exit, level_exit


walk_block.launches = 0


def walk_ragged(
    filled: RaggedMoves,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk every pair of a ragged moves fill from (m, n) up to row 0.

    Args:
        filled: ``fill_cuda.batch_moves_ragged``'s result; pair k's walk
            starts in the level of the least of its final lanes
            ``final3[k]`` (ties M > Ix > Iy: argmin's first index).

    Returns ``(ops (P, L) uint8, count (P,), j_exit (P,))``, int32 on the
    codes' device, row k pair k's op tape (walk order), its length and the
    column where it reached row 0, with L the greatest m + n; ops past
    ``count`` are 0.  The row-0 left moves are the caller's, as with
    :func:`walk_block`.  On CUDA tensors one launch of ``walk_block``'s
    ragged kernel over every pair, on CPU tensors its plain version pair
    by pair through the same descriptors.  ``walk_ragged.launches`` counts
    kernel launches.
    """
    final3, codes, desc, layout = filled
    pairs = final3.shape[0]
    if final3.dim() != 2 or final3.shape[1] != 3 or final3.dtype != torch.int32:
        raise ValueError("final3 must be (P, 3) int32")
    if codes.dim() != 1 or codes.dtype != torch.uint8:
        raise ValueError("codes must be a flat uint8 buffer")
    if layout.shape != (pairs, desc.shape[1]) or tuple(desc.shape) != layout.shape:
        raise ValueError(f"desc and layout must both hold the {pairs} pairs")
    m, n, off, ld, row = (layout[:, k] for k in (2, 3, 4, 5, 6))
    if (np.sort(row) != np.arange(pairs)).any() or (ld < n + 1).any() or (
        (off < 0) | (off + (m + 1) * ld > codes.numel())
    ).any():
        raise ValueError("a descriptor names a final3 row or codes outside "
                         "the fill's")
    for name, x in (("codes", codes), ("desc", desc)):
        if x.device != final3.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {final3.device}")
    length = int((m + n).max()) if pairs else 0
    device = final3.device
    if device.type == "cpu":
        flat, lanes = codes.numpy(), final3.numpy()
        ops = np.zeros((pairs, length), np.uint8)
        count = np.zeros(pairs, np.int32)
        j_exit = np.zeros(pairs, np.int32)
        for _, _, mk, nk, base, stride, r, _ in layout.tolist():
            count[r], j_exit[r], _ = _walk_steps(
                flat, base, stride, mk, nk, int(lanes[r].argmin()), ops[r]
            )
        return tuple(torch.from_numpy(x) for x in (ops, count, j_exit))
    if device.type != "cuda":
        raise ValueError(f"no walk_block route for device {device}")

    from ..utils import cuda_build

    lib = cuda_build.load()
    ops = torch.zeros((pairs, length), dtype=torch.uint8, device=device)
    count, j_exit = (
        torch.empty((pairs,), dtype=torch.int32, device=device) for _ in range(2)
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        walk_ragged.launches += 1
        err = lib.walk_ragged_launch(
            desc.data_ptr(), codes.data_ptr(), final3.data_ptr(),
            ops.data_ptr(), count.data_ptr(), j_exit.data_ptr(), pairs,
            length, stream,
        )
    if err != 0:
        msg = lib.walk_block_error_string(err).decode()
        raise RuntimeError(f"walk_block ragged launch failed: CUDA error {err} "
                           f"({msg})")
    return ops, count, j_exit


walk_ragged.launches = 0


def block_bounds(
    m: int,
    n: int,
    block_rows: int | None = None,
    block_moves_bytes: int = DEFAULT_BLOCK_MOVES_BYTES,
) -> list[int]:
    """Row bounds of the blocks: block b covers rows bounds[b]+1..bounds[b+1].

    Default K: grow blocks until one block's codes reach
    ``block_moves_bytes``, but never below ``DEFAULT_BLOCK_ROWS``.
    """
    if block_rows is None:
        block_rows = max(
            DEFAULT_BLOCK_ROWS, min(m, block_moves_bytes // (n + 1))
        )
    return list(range(0, m, max(1, block_rows))) + [m]


def align_blocked(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    seq_1: str,
    seq_2: str,
    *,
    block_rows: int | None = None,
    block_moves_bytes: int = DEFAULT_BLOCK_MOVES_BYTES,
    mesh=None,
) -> Traceback:
    """Full alignment with O(n * (m/K + K)) memory (module docstring).

    Args:
        tok_a / tok_b: (m+1,) / (n+1,) int32 1-origin tokens on the device
            the alignment runs on (CUDA: the kernels; CPU: their plain
            versions); ``cost_mat`` (A, A) int32 on the same device.
        gap_id / gap_open: the gap token and the gap-open cost.
        seq_1 / seq_2: the strings (for emitting the aligned text).
        block_rows / block_moves_bytes: the checkpoint interval K, or the
            bytes of codes one block may hold (``block_bounds``).
        mesh: optional ``parallel.Mesh``; every rank calls with the same
            arguments (module docstring).

    Spans (``utils.spans``): checkpoints (the boundary and the checkpoint
    pass queued), replays (every block's fill and walk queued), then
    :func:`fetch_walk`'s fetch and :func:`render_walk`'s traceback.
    """
    m, n = len(seq_1), len(seq_2)
    go = int(gap_open)
    with span("checkpoints"):
        row0, col0 = default_boundary(tok_a, tok_b, cost_mat, gap_id, go)
        if m and n:
            bounds = block_bounds(m, n, block_rows, block_moves_bytes)
            rows = _checkpoints(tok_a, tok_b, cost_mat, gap_id, go, row0, col0,
                                bounds, mesh)
    if m == 0 or n == 0:  # one boundary line: no fill, no codes to walk
        final3 = row0[:, n] if m == 0 else col0[:, m]
        cost = int(final3.min())
        return Traceback(
            *render_walk(np.full(m, OP_UP, np.uint8), n, seq_1, seq_2), cost
        )

    with span("replays"):
        # Column-0 Iy seed at each block's top row: the global column-0
        # value, except the top block, whose rows add their icost to
        # gap_open (the corner col0[2, 0] is 0).
        c0_top = col0[2].clone()
        c0_top[0] = go
        final3 = rows[-1][0, :, n]
        j = torch.full((1,), n, dtype=torch.int32, device=tok_a.device)
        level = final3.argmin().to(torch.int32).reshape(1)
        tapes = []  # (ops, count) per block, walk order (bottom block first)
        for b in range(len(bounds) - 2, -1, -1):
            i0, i1 = bounds[b], bounds[b + 1]
            _, moves = batch_moves(
                tok_a[None, i0 : i1 + 1], tok_b[None], cost_mat, gap_id, go,
                [i1 - i0], [n], row0=rows[b], col0y_top=c0_top[i0 : i0 + 1],
            )
            ops, count, j, level = walk_block(moves, [i1 - i0], j, level)
            tapes.append((ops[0], count))

    # One copy: the cost, the counts, the exit column and every tape.
    ints, ops_host = fetch_walk(
        [final3.min().reshape(1), j] + [c for _, c in tapes],
        torch.cat([o for o, _ in tapes]),
    )
    cost, j_exit, counts = int(ints[0]), int(ints[1]), ints[2:].tolist()
    tapes_np, start = [], 0
    for (ops, _), c in zip(tapes, counts):
        tapes_np.append(ops_host[start : start + c])
        start += ops.shape[0]
    return Traceback(
        *render_walk(np.concatenate(tapes_np), j_exit, seq_1, seq_2), cost
    )


def _checkpoints(tok_a, tok_b, cost_mat, gap_id, go, row0, col0, bounds, mesh):
    """The checkpoint pass: (1, 3, n+1) rows at each of ``bounds``, row0
    first (``align_blocked``)."""
    n = tok_b.shape[0] - 1
    nblocks = len(bounds) - 1
    rows = [row0[None]]
    if mesh is not None and mesh.size > 1 and n >= mesh.size:
        from ..parallel.seqpar import ShardedCheckpointFill

        sharded = ShardedCheckpointFill(mesh, tok_b, cost_mat, gap_id, go)
        state = sharded.pad_row0(row0)
        for b in range(nblocks):
            i0, i1 = bounds[b], bounds[b + 1]
            state = sharded.block_last_rows(
                tok_a[i0 : i1 + 1], state, col0[:, i0 : i1 + 1]
            )
            rows.append(state[None, :, : n + 1].contiguous())
    else:  # every block's last row from one fill
        ck = checkpoint_rows(tok_a, tok_b, cost_mat, gap_id, go, bounds[1:])
        rows += [ck[b][None] for b in range(nblocks)]
    return rows


def fetch_walk(ints, ops: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int32 tensors ``ints`` (flattened, in order) and the uint8 ``ops`` on
    the host, in one device-to-host copy (one sync)."""
    with span("fetch"):
        head = torch.cat([x.reshape(-1) for x in ints])
        buf = torch.cat([head.view(torch.uint8), ops.reshape(-1)]).cpu().numpy()
    split = 4 * head.numel()
    return buf[:split].view(np.int32), buf[split:]


def render_walk(ops_walk, j_exit: int, seq_1: str, seq_2: str
                ) -> tuple[str, str, str]:
    """The three alignment lines of a whole walk: ``ops_walk`` in walk order
    (from (m, n) up to row 0), then the ``j_exit`` left moves along row 0
    (reference globaligner.py:542-561), rendered forward
    (:func:`render_ops`).  Both ``align`` routes end here."""
    with span("traceback"):
        fwd = np.concatenate([
            np.full(j_exit, OP_LEFT, np.uint8),
            np.asarray(ops_walk, np.uint8)[::-1],
        ])
        return render_ops(fwd, seq_1, seq_2)


def render_many(
    tapes_fwd, seqs_1, seqs_2
) -> list[tuple[str, str, str]]:
    """The three alignment lines of many pairs' FORWARD-order op tapes.

    Ops: ``OP_DIAG`` consumes a character of each sequence, ``OP_LEFT`` one
    of seq_2 (gap in seq_1), any other op one of seq_1.  Each tape is a
    whole alignment of its pair: it consumes every character of both
    sequences.  The port of the native ``ga_render_ops``
    (``native/runtime.cpp:227``), vectorised with numpy over every op of
    every pair at once (one numpy pass, not a Python loop per op or pair);
    byte-identical to the JAX package's ``assemble_from_tapes`` over the
    reversed tape with the row-0 left moves in front.
    """
    if not len(tapes_fwd):
        return []
    lengths = np.array([len(t) for t in tapes_fwd], np.int64)
    ops = np.concatenate(
        [np.asarray(t, np.uint8).reshape(-1) for t in tapes_fwd]
    )
    text_1, text_2 = "".join(seqs_1), "".join(seqs_2)
    codec, dtype = (
        ("ascii", np.uint8) if text_1.isascii() and text_2.isascii()
        else ("utf-32-le", np.uint32)
    )
    diag, left = ops == OP_DIAG, ops == OP_LEFT
    from_1, from_2 = ~left, diag | left  # ops that consume seq_1 / seq_2
    # The ops that consume a seq_1 character take them in order, pair after
    # pair: the concatenated seq_1s fill those slots (and likewise seq_2).
    c1 = np.full(ops.shape, ord(GAP_CHAR), dtype)
    c2 = c1.copy()
    for out, mask, text in ((c1, from_1, text_1), (c2, from_2, text_2)):
        chars = np.frombuffer(text.encode(codec), dtype)
        if int(mask.sum()) != len(chars):
            raise ValueError("an op tape does not consume its whole sequence")
        out[mask] = chars
    mid = np.full(ops.shape, ord(GAP_GLYPH), dtype)
    mid[diag] = np.where(
        c1[diag] == c2[diag], ord(MATCH_GLYPH), ord(MISMATCH_GLYPH)
    )
    line_1, line_m, line_2 = (x.tobytes().decode(codec) for x in (c1, mid, c2))
    ends = np.cumsum(lengths).tolist()
    return [
        (line_1[lo:hi], line_m[lo:hi], line_2[lo:hi])
        for lo, hi in zip([0] + ends[:-1], ends)
    ]


def render_ops(ops_fwd, seq_1: str, seq_2: str) -> tuple[str, str, str]:
    """The three alignment lines of one pair's forward op tape
    (:func:`render_many` for one pair)."""
    return render_many([ops_fwd], [seq_1], [seq_2])[0]
