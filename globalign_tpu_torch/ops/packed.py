"""A batch call's letters on the device: one upload, one tokenize, a render
a segment.

The counterpart of the native runtime's tokenize and render
(``native/runtime.cpp``: ``ga_tokenize`` :159 and ``ga_render_ops`` :227,
which the JAX package's ``align_pairs`` runs on the host).  An unsharded
``align_pairs`` call:

1. :func:`pack_call`, on the host, once: the letters of every pair it
   dispatches, joined with one ``"".join`` and one ``encode`` —
   bytes when the text is ASCII, UTF-32 code points (int32) otherwise —,
   int64 letter offsets and lengths a sequence, each bucket's slot in one
   int32 token arena, and the lookup table.  Letters outside the alphabet
   are refused here, before anything is queued.
2. :meth:`PackedCall.upload`: the descriptors, the table and the letters
   in one pinned host-to-device copy (``upload.copies`` counts them).
3. :func:`tokenize_ragged`: one launch writes every sequence's 1-origin
   tokens into its bucket row, column 0 and the padding 0 (as
   ``utils.tokenize.encode_padded``); the buckets the fills take are
   contiguous views of the arena (:meth:`PackedCall.bucket`).
4. :func:`render_ragged`, after each segment's walk: one launch renders
   every pair's three alignment lines from its op tape, its exit column
   and the letters already on the device, each line at an int64 offset
   from an exclusive prefix sum of the lines' lengths, into one lines
   buffer a call; :func:`decode_lines` cuts the fetched buffer into
   strings.

On CUDA tensors the wrappers launch ``csrc/tokenize.cu`` and
``csrc/render.cu``; on CPU tensors they run :func:`tokenize_plain` and
:func:`render_plain`, plain PyTorch over the same descriptors (which run
on any device when called directly); any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tokenize import encode_padded
from .traceback import GAP_CHAR, GAP_GLYPH, MATCH_GLYPH, MISMATCH_GLYPH

OP_DIAG, OP_LEFT, OP_UP = 0, 1, 2  # the walk's ops (ops.linear_tb)
ALIGN = 256  # bytes: where each section of the upload starts
TOKEN_WORDS = 4  # int64 words a sequence: letters offset, length, slot, width
RENDER_WORDS = 2  # int64 words a pair: seq_1's and seq_2's letters offsets
ASCII_TABLE = 256  # a byte's token (csrc/tokenize.cu)
MAX_TABLE = 4096  # code points a wide table may hold (shared memory)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``: on a card one non-blocking copy from pinned
    memory (``upload.copies`` counts them), on the CPU ``host`` itself."""
    if device.type == "cpu":
        return host
    upload.copies += 1
    return host.to(device, non_blocking=True)


upload.copies = 0


class PackedCall:
    """The letters of a call's buckets, packed on the host by
    :func:`pack_call`; :meth:`upload` puts them on a device."""

    def __init__(self, wide, host, layout, slots, arena_size, line_cap):
        self.wide = wide  # letters are code points (int32), not bytes
        self.host = host  # the upload: one uint8 buffer
        self.layout = layout  # section -> (byte offset, dtype, shape)
        self.slots = slots  # a bucket's (arena offset of seq_1s, of seq_2s, B, M+1, N+1)
        self.arena_size = arena_size  # int32 tokens
        self.line_cap = line_cap  # letters a line of the lines buffer holds
        self.arena = self.token_desc = self.render_desc = None
        self.table = self.letters = None

    def upload(self, device: torch.device) -> None:
        """One copy of the descriptors, table and letters to ``device``
        and an arena there for the tokens (filled by :meth:`tokenize`)."""
        buf = upload(self.host, device)
        for name, (offset, dtype, shape) in self.layout.items():
            size = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
            setattr(self, name, buf[offset : offset + size].view(dtype).view(shape))
        self.arena = torch.empty(self.arena_size, dtype=torch.int32, device=device)

    def tokenize(self) -> None:
        """Every sequence's tokens into its bucket row: one launch."""
        tokenize_ragged(self.letters, self.table, self.token_desc, self.arena)

    def bucket(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket ``k``'s (B, M+1) / (B, N+1) tokens: views of the arena."""
        slot_a, slot_b, batch, m1, n1 = self.slots[k]
        return (self.arena[slot_a : slot_a + batch * m1].view(batch, m1),
                self.arena[slot_b : slot_b + batch * n1].view(batch, n1))

    def lines(self) -> torch.Tensor:
        """An empty (3, ``line_cap``) lines buffer beside the letters."""
        return torch.empty((3, self.line_cap), dtype=self.letters.dtype,
                           device=self.letters.device)


def pack_call(alphabet, buckets, *, with_render: bool, pin: bool = False,
              on_unknown=None) -> PackedCall:
    """Pack a call's buckets: ``buckets`` lists (seqs_1, seqs_2, M, N) in
    dispatch order, bucket k's pair r at row r of its (B, M+1) / (B, N+1)
    slots.  ``with_render`` adds a render descriptor a pair, in the same
    order; ``pin`` puts the host buffer in pinned memory (for a card).

    A letter outside ``alphabet`` raises before anything is packed:
    ``on_unknown()`` raises the caller's error, by default
    ``encode_padded``'s for the first such sequence in packed order.
    """
    seqs_1 = [s for b in buckets for s in b[0]]
    seqs_2 = [s for b in buckets for s in b[1]]
    text = "".join(seqs_1 + seqs_2)
    wide = not text.isascii()
    if wide:  # the alphabet's letters are single characters
        unknown = not set(alphabet.letters).issuperset(text)
        letters = np.frombuffer(text.encode("utf-32-le"), np.int32)
        table = np.array([ord(c) for c in alphabet.letters], np.int32)
        if len(table) > MAX_TABLE:
            raise ValueError(f"an alphabet of {len(table)} letters passes the "
                             f"tokenizer's {MAX_TABLE}")
    else:
        raw = text.encode("ascii")
        ascii_letters = [(tok, c) for tok, c in enumerate(alphabet.letters)
                         if c.isascii()]
        unknown = bool(raw.translate(None, "".join(c for _, c in ascii_letters).encode()))
        letters = np.frombuffer(raw, np.uint8)
        table = np.zeros(ASCII_TABLE, np.int32)
        for tok, c in ascii_letters:
            table[ord(c)] = tok
    if unknown:
        if on_unknown is not None:
            on_unknown()
        for seq in seqs_1 + seqs_2:
            encode_padded(alphabet, seq, len(seq))
        raise ValueError("a sequence holds a letter outside the alphabet")

    lengths = np.fromiter(map(len, seqs_1 + seqs_2), np.int64,
                          count=len(seqs_1) + len(seqs_2))
    starts = np.cumsum(lengths) - lengths
    pairs = len(seqs_1)
    token = np.zeros((2 * pairs, TOKEN_WORDS), np.int64)
    token[:, 0], token[:, 1] = starts, lengths
    slots, cursor, row = [], 0, 0
    step = ALIGN // 4  # tokens: each slot starts on an ALIGN boundary
    for seqs_a, _, m_pad, n_pad in buckets:
        batch = len(seqs_a)
        slot_a = cursor
        slot_b = slot_a + -(-batch * (m_pad + 1) // step) * step
        cursor = slot_b + -(-batch * (n_pad + 1) // step) * step
        rows = np.arange(batch, dtype=np.int64)
        token[row : row + batch, 2] = slot_a + rows * (m_pad + 1)
        token[row : row + batch, 3] = m_pad + 1
        token[pairs + row : pairs + row + batch, 2] = slot_b + rows * (n_pad + 1)
        token[pairs + row : pairs + row + batch, 3] = n_pad + 1
        slots.append((slot_a, slot_b, batch, m_pad + 1, n_pad + 1))
        row += batch

    sections = {"token_desc": (token, torch.int64)}
    if with_render:
        render = np.stack([starts[:pairs], starts[pairs:]], axis=1)
        sections["render_desc"] = (np.ascontiguousarray(render), torch.int64)
    sections["table"] = (table, torch.int32)
    sections["letters"] = (letters, torch.int32 if wide else torch.uint8)
    layout, offset = {}, 0
    for name, (array, dtype) in sections.items():
        layout[name] = (offset, dtype, array.shape)
        offset += _aligned(array.nbytes)
    host = torch.empty(offset, dtype=torch.uint8, pin_memory=pin)
    buf = host.numpy()
    for name, (array, _) in sections.items():
        at = layout[name][0]
        buf[at : at + array.nbytes] = array.reshape(-1).view(np.uint8)
    line_cap = int(lengths.sum()) if with_render else 0
    return PackedCall(wide, host, layout, slots, cursor, line_cap)


def _check_same_device(device, **tensors):
    for name, x in tensors.items():
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def tokenize_plain(letters, table, desc, arena) -> torch.Tensor:
    """The plain version of :func:`tokenize_ragged`, in PyTorch: every
    element of every descriptor's row at once."""
    if desc.shape[0] == 0:
        return arena
    src, length, slot, width = desc.unbind(1)
    device = desc.device
    row = torch.repeat_interleave(torch.arange(desc.shape[0], device=device), width)
    col = torch.arange(row.numel(), device=device) - (torch.cumsum(width, 0) - width)[row]
    inside = (col >= 1) & (col <= length[row])
    at = torch.where(inside, src[row] + col - 1, 0)
    if letters.numel() == 0:
        tok = torch.zeros_like(col, dtype=torch.int32)
    elif letters.dtype == torch.uint8:
        tok = table[letters[at].long()]
    else:
        hit = letters[at][:, None] == table[None, :]
        tok = torch.where(hit.any(1), hit.int().argmax(1), 0).to(torch.int32)
    arena[slot[row] + col] = torch.where(inside, tok, 0).to(torch.int32)
    return arena


def tokenize_ragged(letters, table, desc, arena) -> torch.Tensor:
    """Every sequence's 1-origin tokens into its row of ``arena``.

    Args:
        letters: the call's letters, (L,) uint8 bytes or int32 code points.
        table: for bytes (256,) int32, a byte's token; for code points
            (A,) int32, token k's code point.  A letter the
            table does not hold tokenizes to 0 (:func:`pack_call` refuses
            such letters first).
        desc: (R, 4) int64 a sequence: its letters' offset and length, the
            arena offset of its row and the row's width (length + 1 at
            least); rows may not overlap.
        arena: (T,) int32 tokens, written in place and returned: row
            element 0 and those past the length 0, element c the token of
            letter c - 1.

    On CUDA tensors one launch of ``csrc/tokenize.cu``
    (``tokenize_ragged.launches`` counts them), on CPU tensors
    :func:`tokenize_plain`.
    """
    wide = letters.dtype == torch.int32
    if letters.dim() != 1 or letters.dtype not in (torch.uint8, torch.int32):
        raise ValueError("letters must be (L,) uint8 or int32")
    if table.dim() != 1 or table.dtype != torch.int32 or (
        table.numel() > MAX_TABLE if wide else table.numel() != ASCII_TABLE
    ):
        raise ValueError("table must be (256,) int32 for bytes, (A,) int32 "
                         f"with A <= {MAX_TABLE} for code points")
    if desc.dim() != 2 or desc.shape[1] != TOKEN_WORDS or desc.dtype != torch.int64:
        raise ValueError("desc must be (R, 4) int64")
    if arena.dim() != 1 or arena.dtype != torch.int32:
        raise ValueError("arena must be (T,) int32")
    device = arena.device
    _check_same_device(device, letters=letters, table=table, desc=desc, arena=arena)
    if device.type == "cpu":
        return tokenize_plain(letters, table, desc, arena)
    if device.type != "cuda":
        raise ValueError(f"no tokenize_ragged route for device {device}")
    if desc.shape[0] == 0:
        return arena

    from ..utils import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tokenize_ragged.launches += 1
        err = lib.tokenize_ragged_launch(
            desc.data_ptr(), desc.shape[0], letters.data_ptr(), int(wide),
            table.data_ptr(), table.numel(), arena.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.tokenize_error_string(err).decode()
        raise RuntimeError(f"tokenize_ragged launch failed: CUDA error {err} ({msg})")
    return arena


tokenize_ragged.launches = 0


def render_plain(ops, count, j_exit, starts, letters, desc, lines) -> torch.Tensor:
    """The plain version of :func:`render_ragged`'s launch, in PyTorch:
    every op of every pair at once."""
    lens = count.long() + j_exit.long()
    total = int(lens.sum())
    if total == 0:
        return lines
    device = ops.device
    pair = torch.repeat_interleave(torch.arange(ops.shape[0], device=device), lens)
    first = (torch.cumsum(lens, 0) - lens)[pair]
    t = torch.arange(total, device=device) - first
    exit_ = j_exit.long()[pair]
    # Forward order: the j_exit row-0 left moves, then the tape reversed.
    back = (count.long()[pair] - 1 - (t - exit_)).clamp(0, max(ops.shape[1] - 1, 0))
    op = ops[pair, back].long() if ops.shape[1] else torch.zeros_like(t)
    op = torch.where(t < exit_, OP_LEFT, op)
    from_1 = op != OP_LEFT
    from_2 = (op == OP_DIAG) | (op == OP_LEFT)

    def consumed(mask):  # letters a pair's ops before each one consume
        before = torch.cumsum(mask.long(), 0) - mask.long()
        return before - before[first]

    last = max(letters.numel() - 1, 0)

    def side(mask, word):
        at = (desc[pair, word] + consumed(mask)).clamp(0, last)
        return torch.where(mask, letters[at], ord(GAP_CHAR))

    a, b = side(from_1, 0), side(from_2, 1)
    mid = torch.where(
        op == OP_DIAG,
        torch.where(a == b, ord(MATCH_GLYPH), ord(MISMATCH_GLYPH)),
        ord(GAP_GLYPH),
    )
    at = starts[pair] + t
    for r, line in enumerate((a, mid, b)):
        lines[r, at] = line.to(lines.dtype)
    return lines


def render_ragged(ops, count, j_exit, letters, desc, lines, base=None
                  ) -> torch.Tensor:
    """Every pair's three alignment lines from its walk, into ``lines``.

    Args:
        ops / count / j_exit: ``linear_tb.walk_ragged``'s (P, L) uint8 op
            tapes in walk order, their (P,) int32 lengths and exit columns.
        letters: the call's letters, uint8 bytes or int32 code points.
        desc: (P, 2) int64, pair k's seq_1 and seq_2 letters offsets.
        lines: (3, C) of the letters' dtype, written in place: pair k's
            line r at ``lines[r, start_k : end_k]`` — seq_1 with gaps, the
            glyphs (``|`` equal letters, ``*`` a mismatched diagonal, a
            space a gap) and seq_2 with gaps, ``count + j_exit`` letters,
            forward order (the row-0 left moves first).
        base: (1,) int64 on the device, where pair 0's lines start (the
            previous segment's last end); default 0.

    Returns the (P,) int64 ends, on the device: starts are their exclusive
    prefix sum from ``base`` (``torch.cumsum``, nothing synchronises).  On
    CUDA tensors one launch of ``csrc/render.cu``
    (``render_ragged.launches`` counts them), a warp a pair; on CPU tensors
    :func:`render_plain`.
    """
    pairs = ops.shape[0]
    if ops.dim() != 2 or ops.dtype != torch.uint8:
        raise ValueError("ops must be (P, L) uint8")
    for name, x in (("count", count), ("j_exit", j_exit)):
        if x.shape != (pairs,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be ({pairs},) int32")
    if desc.shape != (pairs, RENDER_WORDS) or desc.dtype != torch.int64:
        raise ValueError(f"desc must be ({pairs}, 2) int64")
    if letters.dim() != 1 or letters.dtype not in (torch.uint8, torch.int32):
        raise ValueError("letters must be (L,) uint8 or int32")
    if lines.dim() != 2 or lines.shape[0] != 3 or lines.dtype != letters.dtype:
        raise ValueError("lines must be (3, C) of the letters' dtype")
    device = ops.device
    _check_same_device(device, ops=ops, count=count, j_exit=j_exit,
                       letters=letters, desc=desc, lines=lines)
    lens = count.long() + j_exit.long()
    ends = torch.cumsum(lens, 0)
    if base is not None:
        ends += base
    starts = ends - lens
    if device.type == "cpu":
        render_plain(ops, count, j_exit, starts, letters, desc, lines)
        return ends
    if device.type != "cuda":
        raise ValueError(f"no render_ragged route for device {device}")
    if pairs == 0:
        return ends

    from ..utils import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        render_ragged.launches += 1
        err = lib.render_ragged_launch(
            desc.data_ptr(), ops.data_ptr(), ops.shape[1], count.data_ptr(),
            j_exit.data_ptr(), starts.data_ptr(), letters.data_ptr(),
            int(letters.dtype == torch.int32), lines.data_ptr(), lines.shape[1],
            pairs, stream,
        )
    if err != 0:
        msg = lib.render_error_string(err).decode()
        raise RuntimeError(f"render_ragged launch failed: CUDA error {err} ({msg})")
    return ends


render_ragged.launches = 0


def decode_lines(lines: np.ndarray, ends: np.ndarray, wide: bool
                 ) -> list[tuple[str, str, str]]:
    """Each pair's three lines as strings, from a fetched (3, C) lines
    buffer and its (P,) ends (pair 0 at 0): each decoded straight from the
    buffer, so no whole-line string or bytes copy is made (a large fresh
    allocation costs its page faults on every call)."""
    codec, size = ("utf-32-le", 4) if wide else ("ascii", 1)
    line_1, line_m, line_2 = (memoryview(np.ascontiguousarray(lines[r]).view(np.uint8))
                              for r in range(3))
    bounds = [0] + (size * np.asarray(ends, np.int64)).tolist()
    return [
        (str(line_1[lo:hi], codec), str(line_m[lo:hi], codec),
         str(line_2[lo:hi], codec))
        for lo, hi in zip(bounds[:-1], bounds[1:])
    ]
