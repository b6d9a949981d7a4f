"""Batched many-pair alignment: length bucketing, fused fills and walks.

The port of ``globalign_tpu/batch.py`` (``align_pairs`` and its result
types).  Pairs are padded into (M, N) length buckets.  An unsharded call
first packs the letters of every batched pair on the host and sends them
to the device in one copy, where one ``tokenize_ragged`` launch writes
every bucket's tokens into one arena (``ops.packed``: the counterpart of
the native runtime's ``ga_tokenize``); the buckets the fills take are
views of it.  Then:

  * cost-only: every bucket of the call in one
    ``ops.fill_batch.batch_final3_ragged`` call — one ``gotoh_batch``
    launch (a warp per pair) per width class present, and for the buckets
    past its width cap one ``gotoh_tile`` launch over all their pairs
    (``ops.fill_tile.route_buckets``; else a launch a bucket): the
    counterpart of the JAX package's fused cost chunk (``COST_CHUNK_JIT``,
    ``_chunk_costs_jit``);
  * traceback: the buckets of the call in segments, each closed where its
    codes (``fill_cuda.ragged_bytes``: (m+1) rows of n+1 bytes rounded up
    to 16 a pair) would pass the segment capacity (``_segment_budget``: on
    the card a quarter of its memory, never less than the moves budget; on
    the CPU the moves budget), so a call's wide pairs share one launch and
    the card's SMs: per segment one ragged moves
    fill (``fill_cuda.batch_moves_ragged``: one ``gotoh_batch_moves``
    launch a width class for the pairs of at most 1024 columns, one
    ``gotoh_fill`` launch a launch class for the rest), one ragged walk
    (``linear_tb.walk_ragged``: one
    ``walk_block`` launch) from each pair's (m, n) at the argmin level of
    its final3 — the counterpart of the JAX package's chunk-wide device
    walk (``_lanes_walk_fills``, ``_mega_walk_flush``, bounded by
    ``WALK_GROUP_BYTES``) and of ``TB_CHUNK_JIT`` — and one
    ``render_ragged`` launch that writes every pair's three alignment lines
    into the call's lines buffer (``ops.packed``: the counterpart of
    ``ga_render_ops``).  The codes and the op tapes never leave the device.

Final lanes and lines stay on the device until ``resolve()`` (or the end
of a ``flush=True`` call) brings them to the host in one copy and one
synchronisation; the host decodes the lines once and cuts them pair by
pair.  A pair whose codes alone exceed the moves budget takes the blocked
linear-space traceback (``linear_tb.align_blocked``) on its own, eagerly,
from its own tokens (``encode_padded``).

With ``mesh=`` (a ``parallel.Mesh``; every rank calls with the same pairs)
each bucket's batch axis is sharded over the ranks
(``parallel.mesh``): cost-only buckets through ``sharded_fill_costs``,
traceback buckets through ``sharded_fill_moves`` and one ``walk_block`` per
rank on its own shard, whose tapes, counts and exit columns are then
all-gathered — every rank returns every result.  Buckets are issued in the
same order on every rank, so the collectives pair up.  Each rank holds only
its shard's codes, so a traceback sub-batch may hold the moves budget once
per rank; blocked pairs pass the mesh on (a column-sharded checkpoint
pass).  The mesh path keeps the host's tokenize a bucket
(``_encode_bucket``) and renders the fetched tapes on the host
(``linear_tb.render_many``).  On CPU tensors the same code runs the plain versions
of the kernels — the counterpart of the JAX package's CPU branch.  Results
come back in input order with the single-pair API's cost, score and
alignment.

Not ported, by design:
  * the chunk-fusion executables' compile cache (``COST_CHUNK_JIT`` /
    ``TB_CHUNK_JIT``) and the mega-walk's pad quanta (``_BLOB_QUANTUM``,
    ``_ROWS_QUANTUM``, ...), which bound XLA compiles per bucket
    composition: the kernels take every shape at run time, so both
    fusions are always on and compile nothing;
  * ``_moves_backend_estimate``'s per-backend byte models: a pair's codes
    are (M+1)(N+1) bytes on every route — nor, with them, the JAX mesh
    path's budget, which grants host-fetched sharded codes the device
    walk's 1.5 GB (reference fault C.2).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .config import ResolvedScheme, resolve_scheme
from .models.gotoh import GotohAlignment, resolve_device
from .ops import fill_batch, fill_cuda, linear_tb
from .ops import packed as packed_mod
from .ops.transforms import final_cost_to_score
from .parallel import mesh as mesh_mod
from .utils.spans import span
from .utils.tokenize import GAP, encode_padded

DEFAULT_BUCKET_QUANTUM = 32

# Above this many bytes of move codes for one sub-batch, traceback mode
# splits a bucket into sub-batches; past it for one pair, the pair takes
# the blocked linear-space traceback.  On the CPU the codes are host
# memory, and this bound applies (as on the JAX package's CPU branch);
# overridable via GLOBALIGN_BATCH_MOVES_BUDGET_BYTES.
DEFAULT_BATCH_MOVES_BUDGET = int(
    os.environ.get("GLOBALIGN_BATCH_MOVES_BUDGET_BYTES", 256 * 1024 * 1024)
)

# The same bound on the card, where the codes never leave device memory
# (only the rendered lines cross to the host): every traceback bucket is
# walked and rendered on the device.  It decides the blocked route and the
# mesh path's sub-batches there; an unsharded call's segments may hold more
# (``_segment_budget``).
DEVICE_WALK_MOVES_BUDGET = 1536 * 1024 * 1024


@dataclass
class PendingAlignments:
    """A dispatched-but-unfetched :func:`align_pairs` call.

    Returned by ``align_pairs(..., flush=False)``: every bucket's fill (and
    walk and render, in traceback mode) is queued on the device, nothing
    has been fetched.  ``resolve()`` waits for the device, fetches, renders and
    returns the results — the runner dispatches chunk k+1 before resolving
    chunk k, so the host's fetch and render overlap the device's fills.
    """

    _flush: object

    def resolve(self) -> "list[PairResult]":
        return self._flush()


@dataclass(frozen=True)
class PairResult:
    """Result for one pair in a batch (traceback fields None in cost-only mode)."""

    cost: int
    score: int
    seq_1_aligned: str | None = None
    middle_part: str | None = None
    seq_2_aligned: str | None = None

    def cigar(self, extended: bool = True) -> str | None:
        """CIGAR of the alignment, or None in cost-only mode."""
        if self.seq_1_aligned is None:
            return None
        from .ops.traceback import alignment_to_cigar

        return alignment_to_cigar(
            self.seq_1_aligned, self.seq_2_aligned, extended=extended
        )


def bucket_length(length: int, quantum: int = DEFAULT_BUCKET_QUANTUM) -> int:
    """Round a sequence length up to the bucket grid (next multiple of quantum)."""
    return max(quantum, quantum * math.ceil(length / quantum))


def _validate_pairs(pairs: Sequence[tuple[str, str]]) -> list[tuple[str, str]]:
    out = []
    for idx, (s1, s2) in enumerate(pairs):
        if len(s1) == 0 or len(s2) == 0:
            raise RuntimeError(f"Pair {idx}: detected a sequence of length 0.")
        if GAP in s1 or GAP in s2:
            raise RuntimeError(
                f"Pair {idx}: sequences may not contain the '-' character."
            )
        out.append((s1.upper(), s2.upper()))
    return out


def _moves_budget(device: torch.device) -> int:
    """Bytes of codes one traceback sub-batch may hold on ``device``."""
    if device.type == "cuda":
        return DEVICE_WALK_MOVES_BUDGET
    return DEFAULT_BATCH_MOVES_BUDGET


@functools.cache
def _card_memory(index: int) -> int:
    """Total bytes of card ``index``'s memory (a query is too slow for every
    call).  Total, not free: a call's segments depend on its pairs and the
    card alone, never on what the allocator holds at the time."""
    return torch.cuda.get_device_properties(index).total_memory


def _segment_budget(device: torch.device) -> int:
    """Bytes of codes one unsharded traceback segment may hold on
    ``device``: on a card a quarter of its memory, so the runner's one-deep
    pipeline (the next call queued before this one resolves) keeps two
    calls' segments within half of it, and never less than the moves
    budget; on the CPU the moves budget."""
    budget = _moves_budget(device)
    if device.type == "cuda":
        return max(budget, _card_memory(device.index) // 4)
    return budget


def _encode_bucket(alphabet, seqs: list[str], padded_len: int) -> np.ndarray:
    """(B, padded_len + 1) int32 1-origin tokens: ``encode_padded`` of each
    sequence, vectorised over an ASCII bucket with one lookup table
    (``encode_padded`` looks every character up in Python).  The mesh
    path's tokenize; an unsharded call tokenizes on its device
    (``ops.packed``)."""
    out = np.zeros((len(seqs), padded_len + 1), np.int32)
    text = "".join(seqs)
    if text.isascii():
        lut = np.full(128, -1, np.int32)
        for token, letter in enumerate(alphabet.letters):
            if letter.isascii():
                lut[ord(letter)] = token
        codes = lut[np.frombuffer(text.encode("ascii"), np.uint8)]
        if (codes >= 0).all():
            lengths = np.array([len(s) for s in seqs])
            # Row-major order of the mask is the concatenated text's order.
            out[:, 1:][np.arange(padded_len) < lengths[:, None]] = codes
            return out
    for row, seq in enumerate(seqs):  # alphabet.encode names an unknown letter
        out[row] = encode_padded(alphabet, seq, padded_len)
    return out


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory without
    a host synchronisation."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Every tensor on the host: from a card in one device-to-host copy of
    their bytes and one synchronisation (``_to_host.copies`` counts the
    copies)."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    _to_host.copies += 1
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    buf, out, lo = host.numpy(), [], 0
    for t in tensors:
        size = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(buf[lo : lo + size].view(dtype).reshape(t.shape))
        lo += size
    return out


_to_host.copies = 0


def _raise_unknown(alphabet, pairs, buckets, blocked) -> None:
    """Raise what encoding the call bucket by bucket raises for a letter
    outside ``alphabet``: ``Alphabet.encode``'s error for the first such
    sequence, in the order the per-bucket encode met them (a bucket's
    seq_1s, then its seq_2s; a blocked bucket pair by pair)."""
    for key, indices in buckets.items():
        if key in blocked:
            seqs = [s for i in indices for s in pairs[i]]
        else:
            seqs = [pairs[i][0] for i in indices] + [pairs[i][1] for i in indices]
        for seq in seqs:
            alphabet.encode(seq)


@dataclass
class _Dispatched:
    """Pairs on the device — a traceback segment, the call's cost-only
    buckets, or over a mesh one bucket sub-batch: their final lanes and, in
    traceback mode, where their rendered lines end in the call's lines
    buffer (unsharded) or their op tapes (row k pair k, walk order), tape
    lengths and exit columns (over a mesh)."""

    indices: list[int]
    final3: torch.Tensor
    ends: torch.Tensor | None = None
    ops: torch.Tensor | None = None
    count: torch.Tensor | None = None
    j_exit: torch.Tensor | None = None


def align_pairs(
    pairs: Sequence[tuple[str, str]],
    *,
    scheme: ResolvedScheme | None = None,
    scoring_mat_name: str | None = None,
    scoring_mat_path=None,
    match_score=None,
    mismatch_score=None,
    mismatch_cost=None,
    gap_open_score=None,
    gap_open_cost=None,
    gap_extension_score=None,
    gap_extension_cost=None,
    with_traceback: bool = True,
    bucket_quantum: int = DEFAULT_BUCKET_QUANTUM,
    device: str | torch.device = "cuda",
    mesh=None,
    phase_seconds: dict | None = None,
    flush: bool = True,
) -> "list[PairResult] | PendingAlignments":
    """Align many independent pairs on ``device``, in input order.

    Scheme options mirror :func:`globalign_tpu_torch.find_global_alignment`;
    a pre-resolved ``scheme`` may be passed instead.  ``device="cuda"`` (the
    default) raises without a GPU; ``device="cpu"`` runs the plain engine.
    ``mesh`` (a ``parallel.Mesh``) shards each bucket over its ranks
    (module docstring); ``device`` is then this rank's.

    ``phase_seconds`` (optional dict) accumulates host wall-clock per phase:
    "validate" (checking and upper-casing the pairs), "scheme" (resolving
    the scheme, its costs to the device), "bucket" (grouping the pairs by
    padded lengths), "pack" (unsharded: the call's letters packed, sent to
    the device in one copy and tokenized there), "encode" (over a mesh:
    each bucket's tokens), "fill" (fills and walks queued), "render"
    (unsharded traceback: the lines' render queued), "blocked" (pairs past
    the moves budget, fill to strings), "fetch" (waiting for the device and
    the device-to-host copy), "traceback" (the lines cut into strings, or
    over a mesh rendered from the tapes) and "results" (costs to scores and
    results).  Together they cover the call.  Each phase is also a
    ``torch.profiler.record_function`` range, ``globalign.<phase>``.

    ``flush=False`` returns a :class:`PendingAlignments` whose ``resolve()``
    runs the fetch and the rest; nothing synchronises with the device
    before it (pairs past the moves budget excepted).

    ``align_pairs.segments`` counts the traceback segments that unsharded
    calls dispatch, each one ``fill`` phase (a ragged fill and its walk)
    and one ``render``.
    """
    dev = resolve_device(device)

    def _phase(name):
        return span(name, phase_seconds)

    with _phase("validate"):
        pairs = _validate_pairs(pairs)
    if not pairs:
        return []

    with _phase("scheme"):
        if scheme is None:
            # Union alphabet across the batch: for simple schemes the matrix
            # entries depend only on char-class (match/mismatch/gap), so a
            # wider alphabet leaves every pair's cost and score unchanged
            # relative to the reference's per-pair alphabet
            # (start.py:355-358).
            all_1 = "".join(s1 for s1, _ in pairs)
            all_2 = "".join(s2 for _, s2 in pairs)
            scheme = resolve_scheme(
                all_1,
                all_2,
                scoring_mat_name=scoring_mat_name,
                scoring_mat_path=scoring_mat_path,
                match_score=match_score,
                mismatch_score=mismatch_score,
                mismatch_cost=mismatch_cost,
                gap_open_score=gap_open_score,
                gap_open_cost=gap_open_cost,
                gap_extension_score=gap_extension_score,
                gap_extension_cost=gap_extension_cost,
            )
        cost_mat = _to_device(np.asarray(scheme.costing.values, np.int32), dev)
    gap_id = scheme.alphabet.gap_id
    gap_open = scheme.gap_open_cost

    with _phase("bucket"):
        # Bucket by padded (M, N).
        buckets: dict[tuple[int, int], list[int]] = {}
        for idx, (s1, s2) in enumerate(pairs):
            key = (
                bucket_length(len(s1), bucket_quantum),
                bucket_length(len(s2), bucket_quantum),
            )
            buckets.setdefault(key, []).append(idx)
        budget = _moves_budget(dev)
        # Buckets whose padded pair's codes alone pass the budget: the
        # checkpointed linear-space traceback, pair by pair.
        blocked = [key for key in buckets
                   if with_traceback and fill_cuda.ragged_bytes(*key) > budget]
        batched = [(key, indices) for key, indices in buckets.items()
                   if key not in blocked]
        lengths = [([len(pairs[i][0]) for i in indices],
                    [len(pairs[i][1]) for i in indices])
                   for _, indices in batched]
        segments = (_segments(lengths, _segment_budget(dev))
                    if with_traceback and mesh is None else [])

    packed = lines = None
    if mesh is None and batched:
        with _phase("pack"):
            packed = packed_mod.pack_call(
                scheme.alphabet,
                [([pairs[i][0] for i in indices], [pairs[i][1] for i in indices],
                  M, N) for (M, N), indices in batched],
                with_render=with_traceback, pin=dev.type == "cuda",
                on_unknown=lambda: _raise_unknown(scheme.alphabet, pairs,
                                                  buckets, blocked),
            )
            packed.upload(dev)
            packed.tokenize()
            if with_traceback:
                lines = packed.lines()

    def score_of(idx: int, cost: int) -> int:
        s1, s2 = pairs[idx]
        return final_cost_to_score(
            cost=cost, m=len(s1), n=len(s2), max_score=scheme.max_score
        )

    results: list[PairResult | None] = [None] * len(pairs)
    dispatched: list[_Dispatched] = []

    for key in blocked:
        for idx in buckets[key]:
            s1, s2 = pairs[idx]
            with _phase("blocked"):
                tb = linear_tb.align_blocked(
                    _to_device(encode_padded(scheme.alphabet, s1, len(s1)), dev),
                    _to_device(encode_padded(scheme.alphabet, s2, len(s2)), dev),
                    cost_mat, gap_id, gap_open, s1, s2, mesh=mesh,
                )
                results[idx] = PairResult(
                    cost=tb.cost,
                    score=score_of(idx, tb.cost),
                    seq_1_aligned=tb.seq_1_aligned,
                    middle_part=tb.middle_part,
                    seq_2_aligned=tb.seq_2_aligned,
                )

    def runs(parts):
        """Rows lo..hi of batched bucket k, for each (k, lo, hi) of
        ``parts``: (indices, tok_a, tok_b, m_true, n_true) each, the tokens
        views of the arena."""
        out = []
        for k, lo, hi in parts:
            tok_a, tok_b = packed.bucket(k)
            m_true, n_true = lengths[k]
            out.append((batched[k][1][lo:hi], tok_a[lo:hi], tok_b[lo:hi],
                        m_true[lo:hi], n_true[lo:hi]))
        return zip(*out)

    if mesh is not None:
        for (M, N), indices in batched:
            groups = [indices]
            if with_traceback:
                # Split oversized buckets into sub-batches under the budget
                # (a rank's share of a sub-batch) rather than losing the
                # batched path.
                max_pairs = budget // fill_cuda.ragged_bytes(M, N) * mesh.size
                groups = [
                    indices[lo : lo + max_pairs]
                    for lo in range(0, len(indices), max_pairs)
                ]
            for group in groups:
                with _phase("encode"):
                    tok_a = _encode_bucket(
                        scheme.alphabet, [pairs[i][0] for i in group], M)
                    tok_b = _encode_bucket(
                        scheme.alphabet, [pairs[i][1] for i in group], N)
                with _phase("fill"):
                    dispatched.append(_sharded_bucket(
                        mesh, group, tok_a, tok_b, cost_mat, gap_id, gap_open,
                        [len(pairs[i][0]) for i in group],
                        [len(pairs[i][1]) for i in group], with_traceback,
                    ))
    elif with_traceback:
        line_end = None  # where the last rendered pair's lines end
        rendered = 0  # traceback pairs rendered: the next render descriptor
        for segment in segments:
            align_pairs.segments += 1
            with _phase("fill"):
                groups, tok_as, tok_bs, m_trues, n_trues = runs(segment)
                filled = fill_cuda.batch_moves_ragged(
                    tok_as, tok_bs, cost_mat, gap_id, gap_open, m_trues, n_trues
                )
                with span("fill.walk"):
                    ops, count, j_exit = linear_tb.walk_ragged(filled)
            with _phase("render"):
                lo, rendered = rendered, rendered + ops.shape[0]
                line_end = packed_mod.render_ragged(
                    ops, count, j_exit, packed.letters,
                    packed.render_desc[lo:rendered], lines,
                    None if line_end is None else line_end[-1:],
                )
            dispatched.append(_Dispatched(
                [idx for group in groups for idx in group], filled.final3,
                line_end,
            ))
    elif batched:  # every cost-only bucket of the call in one ragged fill
        with _phase("fill"):
            groups, tok_as, tok_bs, m_trues, n_trues = runs(
                [(k, 0, len(indices)) for k, (_, indices) in enumerate(batched)]
            )
            final3 = fill_batch.batch_final3_ragged(
                tok_as, tok_bs, cost_mat, gap_id, gap_open, m_trues, n_trues
            )
        dispatched.append(
            _Dispatched([idx for group in groups for idx in group], final3)
        )

    def _flush() -> list[PairResult]:
        if not dispatched:
            return results  # type: ignore[return-value]
        with _phase("fetch"):
            device_parts = [torch.cat([d.final3 for d in dispatched])]
            if with_traceback and mesh is None:
                device_parts += [torch.cat([d.ends for d in dispatched]), lines]
            elif with_traceback:
                device_parts += [
                    torch.cat([d.ops.reshape(-1) for d in dispatched]),
                    torch.cat([d.count for d in dispatched]),
                    torch.cat([d.j_exit for d in dispatched]),
                ]
            fetched = _to_host(device_parts)
        order = [idx for d in dispatched for idx in d.indices]
        strings = [(None, None, None)] * len(order)
        if with_traceback:
            with _phase("traceback"):
                if mesh is None:
                    strings = packed_mod.decode_lines(
                        fetched[2], fetched[1], packed.wide
                    )
                else:
                    strings = _render_tapes(dispatched, *fetched[1:], [
                        pairs[idx] for idx in order
                    ])
        with _phase("results"):
            costs = fetched[0].min(axis=1).tolist()
            for idx, cost, (s1a, midl, s2a) in zip(order, costs, strings):
                results[idx] = PairResult(cost, score_of(idx, cost), s1a, midl,
                                          s2a)
        dispatched.clear()
        return results  # type: ignore[return-value]

    if flush:
        return _flush()
    return PendingAlignments(_flush)


align_pairs.segments = 0


def _segments(lengths, budget: int) -> list[list[tuple[int, int, int]]]:
    """The traceback segments of an unsharded call: batched bucket k's
    pairs have the (m_true, n_true) lists ``lengths[k]``; buckets in order,
    each one's pairs in order, a segment closed where its codes
    (``fill_cuda.ragged_bytes`` a pair) would pass ``budget``.  Each
    segment lists its runs (k, lo, hi): rows lo..hi of bucket k."""
    segments, runs, used = [], [], 0
    for k, (m_true, n_true) in enumerate(lengths):
        lo = 0
        for row, size in enumerate(fill_cuda.ragged_bytes(
                np.asarray(m_true, np.int64), np.asarray(n_true, np.int64)).tolist()):
            if used + size > budget and used:
                if row > lo:
                    runs.append((k, lo, row))
                    lo = row
                segments.append(runs)
                runs, used = [], 0
            used += size
        runs.append((k, lo, len(m_true)))
    if runs:
        segments.append(runs)
    return segments


def _render_tapes(dispatched, tapes, counts, j_exits, order_pairs):
    """The lines of a mesh call's pairs from their fetched walk tapes: each
    tape reversed behind its row-0 left moves (the walk records from (m, n)
    upward and stops at row 0 with j_exit LEFT moves remaining, reference
    globaligner.py:542-561), rendered by ``linear_tb.render_many``."""
    left = np.full(j_exits.max(), linear_tb.OP_LEFT, np.uint8)
    fwd, row, off = [], 0, 0
    for d in dispatched:
        width = d.ops.shape[1]
        for k in range(len(d.indices)):
            start = off + k * width
            tape = tapes[start : start + counts[row + k]]
            fwd.append(np.concatenate((left[: j_exits[row + k]], tape[::-1])))
        row += len(d.indices)
        off += d.ops.numel()
    return linear_tb.render_many(
        fwd, [s1 for s1, _ in order_pairs], [s2 for _, s2 in order_pairs]
    )


def _sharded_bucket(mesh, group, tok_a, tok_b, cost_mat, gap_id, gap_open,
                    m_true, n_true, with_traceback) -> _Dispatched:
    """One bucket sub-batch sharded over ``mesh``: its results on every
    rank, where the unsharded path leaves them on the device."""
    if not with_traceback:
        return _Dispatched(group, mesh_mod.sharded_fill_costs(
            mesh, tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true
        ))
    shard = mesh_mod.sharded_fill_moves(
        mesh, tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true
    )
    # Each rank walks its own shard's codes where they lie.
    ops, count, j_exit, _ = linear_tb.walk_block(
        shard.moves, shard.shard_m,
        _to_device(np.asarray(shard.shard_n, np.int32), cost_mat.device),
        shard.shard_final3.argmin(-1).to(torch.int32),
    )
    ops, count, j_exit = (
        mesh_mod.gather_batch(mesh, x, len(group)) for x in (ops, count, j_exit)
    )
    return _Dispatched(group, shard.final3, ops=ops, count=count, j_exit=j_exit)


def alignment_to_pair_result(a: GotohAlignment) -> PairResult:
    return PairResult(
        cost=a.cost,
        score=a.score,
        seq_1_aligned=a.seq_1_aligned,
        middle_part=a.middle_part,
        seq_2_aligned=a.seq_2_aligned,
    )
