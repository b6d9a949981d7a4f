"""GotohAligner — the flagship alignment model, in PyTorch.

The port of ``globalign_tpu/models/gotoh.py``.  For one pair:

    tokenize -> device fill (ops.fill_cuda: the CUDA kernel on a card, the
                row scan of ops.fill_rows on the CPU)
             -> host traceback over move codes (ops.traceback)
             -> final cost->score transform (ops.transforms)

plus cost-only and planes-debug entry points.

The device is explicit: ``device="cuda"`` (the default) raises when no GPU
is present, and the CPU engine runs only when ``device="cpu"`` is passed.
The kernel takes true lengths at run time, so inputs are not padded.
Past the moves budget the JAX package switches to the blocked linear-space
traceback (``ops/linear_tb.align_blocked``); that path is not ported yet,
and ``align`` refuses such pairs instead of doing anything else.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import ResolvedScheme
from ..ops import fill_cuda, fill_rows
from ..ops.traceback import traceback_moves
from ..ops.transforms import final_cost_to_score

# Above this many bytes of move codes, (m+1)*(n+1), align() would need the
# blocked linear-space traceback (64 MiB ~ 8k x 8k pairs).  The default
# bounds both the device buffer and the host copy of the move plane;
# raise it per-aligner (moves_budget_bytes=...) or process-wide via
# GLOBALIGN_MOVES_BUDGET_BYTES.
DEFAULT_MOVES_BUDGET_BYTES = int(
    _os.environ.get("GLOBALIGN_MOVES_BUDGET_BYTES", 64 * 1024 * 1024)
)


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
        return fill_cuda.batch_moves(
            self._encode(seq_1)[None],
            self._encode(seq_2)[None],
            self.cost_mat,
            self.gap_id,
            self.gap_open,
            [len(seq_1)],
            [len(seq_2)],
            want_moves=want_moves,
        )

    def cost(self, seq_1: str, seq_2: str) -> int:
        """Optimal alignment cost only (O(m+n) device memory on the card)."""
        final3, _ = self._batch_fill(seq_1, seq_2, want_moves=False)
        return int(final3.min())

    def align(self, seq_1: str, seq_2: str) -> GotohAlignment:
        """Full alignment with deterministic traceback."""
        m, n = len(seq_1), len(seq_2)
        moves_bytes = (m + 1) * (n + 1)
        if moves_bytes > self.moves_budget_bytes:
            raise NotImplementedError(
                f"a {m} x {n} pair needs {moves_bytes} bytes of "
                f"move codes, over the {self.moves_budget_bytes}-byte moves "
                "budget; the blocked linear-space traceback that aligns such "
                "pairs is not yet ported (ROADMAP A6)"
            )
        final3, moves = self._batch_fill(seq_1, seq_2, want_moves=True)
        tb = traceback_moves(
            moves[0].cpu().numpy(),
            seq_1,
            seq_2,
            final3[0].cpu().numpy(),
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
