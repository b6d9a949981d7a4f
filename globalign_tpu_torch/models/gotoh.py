"""GotohAligner — the flagship alignment model, in PyTorch.

The port of ``globalign_tpu/models/gotoh.py``.  For one pair:

    tokenize -> device fill (ops.fill_cuda: a CUDA kernel on a card —
                gotoh_tile where ops.fill_tile.route sends a large pair,
                gotoh_fill else —, the row scan of ops.fill_rows on the CPU)
             -> device walk over the move codes (ops.linear_tb.walk_block:
                the walk kernel on a card, the plain walk on the CPU)
             -> one fetch of final3 and the op tape (at most m + n bytes)
             -> host render of the tape (ops.linear_tb.render_walk)
             -> final cost->score transform (ops.transforms)

The code matrix never leaves the device.  Past the moves budget ``align``
runs the blocked linear-space traceback instead
(``ops.linear_tb.align_blocked``: checkpoint fills, then block replays
walked on the device, rendered by the same ``render_walk``),
bit-identical to the full-matrix route.
``cost`` runs the meet-in-the-middle split (``ops.fill_split``) from
``SPLIT_MIN_ROWS`` rows and one cost-only fill below; ``dp_planes`` is a
debug view.

The device is explicit: ``device="cuda"`` (the default) raises when no GPU
is present, and the CPU engine runs only when ``device="cpu"`` is passed.
The kernels take true lengths at run time, so inputs are not padded.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import ResolvedScheme
from ..ops import fill_cuda, fill_rows, linear_tb
from ..ops.fill_split import split_fill_cost
from ..ops.traceback import Traceback
from ..ops.transforms import final_cost_to_score
from ..utils.spans import span

# Above this many bytes of move codes, (m+1)*(n+1), align() switches to the
# blocked linear-space traceback (64 MiB ~ 8k x 8k pairs), whose blocks of
# codes then stay within it (down to 512 rows a block).  The default
# bounds the device buffer of the move plane;
# raise it per-aligner (moves_budget_bytes=...) or process-wide via
# GLOBALIGN_MOVES_BUDGET_BYTES.
DEFAULT_MOVES_BUDGET_BYTES = int(
    _os.environ.get("GLOBALIGN_MOVES_BUDGET_BYTES", 64 * 1024 * 1024)
)

# cost() runs the meet-in-the-middle split from this many rows of seq_1 up
# and one direct cost-only fill below it.  The split adds 0.3-1.2 ms of
# gathers, a 2-pair launch and the join, and saves m/2 waves.  On an H100
# (m 24..8192 x n 64..20 000) it lost below 1024 rows at every width, and
# from 1024 rows lost at most 0.25 ms (narrow pairs) while winning up to 2x
# (a grid measured by ``chip_smoke.py``, which commit b226048 holds).
SPLIT_MIN_ROWS = 1024


@dataclass(frozen=True)
class GotohAlignment:
    seq_1_aligned: str
    middle_part: str
    seq_2_aligned: str
    cost: int
    score: int


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device``; raises if it is CUDA without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch engine"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


class GotohAligner(nn.Module):
    """Affine-gap global aligner for a fixed resolved scheme.

    The scheme (alphabet + costing matrix + gap-open) is bound once; the
    costing matrix is the int32 buffer ``cost_mat`` on the aligner's device.
    """

    def __init__(
        self,
        scheme: ResolvedScheme,
        *,
        moves_budget_bytes: int = DEFAULT_MOVES_BUDGET_BYTES,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.scheme = scheme
        self.moves_budget_bytes = moves_budget_bytes
        self.gap_id = scheme.alphabet.gap_id
        self.gap_open = scheme.gap_open_cost
        self.register_buffer(
            "cost_mat",
            torch.as_tensor(
                np.ascontiguousarray(scheme.costing.values, dtype=np.int32),
                device=resolve_device(device),
            ),
        )

    @property
    def device(self) -> torch.device:
        return self.cost_mat.device

    # -- single pair ------------------------------------------------------

    def _encode(self, seq: str) -> torch.Tensor:
        """(len+1,) int32 1-origin tokens on the aligner's device."""
        tok = np.zeros(len(seq) + 1, dtype=np.int32)
        tok[1:] = self.scheme.alphabet.encode(seq)
        return torch.from_numpy(tok).to(self.device)

    def fill(self, seq_1: str, seq_2: str, *, want_moves=True, want_planes=False):
        """The plain row scan on the aligner's device (test/debug view)."""
        return fill_rows.row_fill(
            self._encode(seq_1),
            self._encode(seq_2),
            self.cost_mat,
            self.gap_id,
            self.gap_open,
            want_moves=want_moves,
            want_planes=want_planes,
        )

    def _batch_fill(self, seq_1: str, seq_2: str, *, want_moves: bool):
        return self._fill_tokens(
            self._encode(seq_1), self._encode(seq_2), want_moves=want_moves
        )

    def _fill_tokens(self, tok_a, tok_b, *, want_moves: bool):
        """One pair's fill from its tokens (``_encode``)."""
        return fill_cuda.batch_moves(
            tok_a[None],
            tok_b[None],
            self.cost_mat,
            self.gap_id,
            self.gap_open,
            [tok_a.shape[0] - 1],
            [tok_b.shape[0] - 1],
            want_moves=want_moves,
        )

    def cost(self, seq_1: str, seq_2: str) -> int:
        """Optimal alignment cost only (O(m+n) device memory on the card):
        the meet-in-the-middle split from ``SPLIT_MIN_ROWS`` rows, one
        cost-only fill below."""
        if len(seq_1) >= SPLIT_MIN_ROWS:
            return int(
                split_fill_cost(
                    self._encode(seq_1),
                    self._encode(seq_2),
                    self.cost_mat,
                    self.gap_id,
                    self.gap_open,
                )
            )
        final3, _ = self._batch_fill(seq_1, seq_2, want_moves=False)
        return int(final3.min())

    def align(self, seq_1: str, seq_2: str) -> GotohAlignment:
        """Full alignment with deterministic traceback: the full move matrix
        walked where it was filled (one fill launch, ``gotoh_tile`` or
        ``gotoh_fill`` as ``fill_tile.route`` says, and one ``walk_block``
        launch on a card) up to the moves budget, blocked past it.  Its
        spans (``utils.spans``): encode, then fill (the fill and the walk
        queued) or ``align_blocked``'s, then fetch and traceback."""
        m, n = len(seq_1), len(seq_2)
        with span("encode"):
            tok_a, tok_b = self._encode(seq_1), self._encode(seq_2)
        if (m + 1) * (n + 1) > self.moves_budget_bytes:
            tb = linear_tb.align_blocked(
                tok_a,
                tok_b,
                self.cost_mat,
                self.gap_id,
                self.gap_open,
                seq_1,
                seq_2,
                block_moves_bytes=self.moves_budget_bytes,
            )
        else:
            with span("fill"):
                final3, moves = self._fill_tokens(tok_a, tok_b, want_moves=True)
                j = torch.full((1,), n, dtype=torch.int32, device=self.device)
                level = final3[0].argmin().to(torch.int32).reshape(1)
                ops, count, j_exit, _ = linear_tb.walk_block(moves, [m], j, level)
            ints, ops_host = linear_tb.fetch_walk(
                [final3[0].min().reshape(1), count, j_exit], ops[0]
            )
            cost, steps, j_row0 = (int(x) for x in ints)
            tb = Traceback(
                *linear_tb.render_walk(ops_host[:steps], j_row0, seq_1, seq_2),
                cost,
            )
        score = final_cost_to_score(
            cost=tb.cost,
            m=m,
            n=n,
            max_score=self.scheme.max_score,
        )
        return GotohAlignment(
            seq_1_aligned=tb.seq_1_aligned,
            middle_part=tb.middle_part,
            seq_2_aligned=tb.seq_2_aligned,
            cost=tb.cost,
            score=score,
        )

    def dp_planes(self, seq_1: str, seq_2: str) -> np.ndarray:
        """Dense (3, m+1, n+1) DP cost planes — test/debug oracle view."""
        res = self.fill(seq_1, seq_2, want_moves=False, want_planes=True)
        return res.planes.cpu().numpy()
