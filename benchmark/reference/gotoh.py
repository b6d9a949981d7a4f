"""Plain global alignment with affine gaps (Gotoh), in PyTorch.

The recurrence in cost space, for seq_1 = a (rows i) and seq_2 = b
(columns j), with go the gap-open cost:

    M [i,j] = min(M, Ix, Iy)[i-1,j-1]          + cost(a_i, b_j)
    Ix[i,j] = min(M + go, Ix, Iy + go)[i,j-1]  + cost('-', b_j)
    Iy[i,j] = min(M + go, Ix + go, Iy)[i-1,j]  + cost(a_i, '-')

with M = Ix = Iy = 0 at (0, 0), Ix[0,j] = go + cost('-', b_1..b_j) along
row 0, Iy[i,0] = go + cost(a_1..a_i, '-') down column 0, and every other
boundary entry unreachable.  The cost is min(M, Ix, Iy) at (m, n).

Ties are broken in a fixed order of the three levels, M before Ix before
Iy: for the level the walk starts in at (m, n), and for each
cell's predecessor.  The walk goes from (m, n) to (0, 0); on row 0 only
Ix steps remain and on column 0 only Iy steps.  A diagonal step writes
``|`` for equal letters and ``*`` otherwise; a gap writes ``-`` in the
sequence line and a space in the middle line.

The fill runs by anti-diagonals, every cell of one vectorised over a group
of pairs; each pair's predecessor codes are kept in diagonal order and
walked on the same device.  Nothing here comes from the program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .scheme import Costing

BIG = 1 << 30
DIAG, LEFT, UP, DONE = 0, 1, 2, 255  # a walk step: the level it leaves


def _group_fill(a, b, m, n, costing: Costing, want_codes: bool):
    """Fill one group of pairs: ``a`` (B, Mx+1), ``b`` (B, Nx+1) letter
    indices from position 1 on, true lengths ``m``, ``n`` (B,).  Returns
    final (B, 3) and the codes (Mx+Nx+1, B, Mx+1) uint8, or None.

    A diagonal d holds cells (i, d - i) for i = 0..Mx as one (3, B, Mx+1)
    tensor of the levels (M, Ix, Iy); cells with d - i outside 0..Nx hold
    values that no cell inside depends on."""
    dev = a.device
    B, L = a.shape[0], a.shape[1]
    Mx, Nx = L - 1, b.shape[1] - 1
    D = Mx + Nx + 1
    cost = torch.as_tensor(costing.cost, dtype=torch.int32, device=dev)
    A, gap, go = cost.shape[0], costing.gap, costing.gap_open
    if int(costing.cost.max()) * (D + 1) + go >= BIG:
        raise ValueError("costs could reach the unreachable sentinel")
    flat = cost.reshape(-1)
    a_row = a * A
    ins = cost[a, gap]  # (B, L): a letter of seq_1 against a gap
    ins[:, 0] = 0
    # seq_2's letters along a diagonal: for diagonal d, row i reads
    # b[d - i] = rev[:, T - 1 - L - d + i], a view of the reversed, padded b.
    T = L + Nx + 1 + L
    padded = torch.zeros((B, T), dtype=torch.int64, device=dev)
    padded[:, L:L + Nx + 1] = b
    rev = padded.flip(1).contiguous()
    rev_del = cost[gap][rev]  # a letter of seq_2 against a gap
    dels = cost[gap][b]
    dels[:, 0] = 0
    # Row 0 (cell (0, d)) and column 0 (cell (d, 0)) of each diagonal.
    row0 = torch.full((3, B, D), BIG, dtype=torch.int32, device=dev)
    row0[1, :, :Nx + 1] = go + torch.cumsum(dels, 1, dtype=torch.int32)
    col0 = torch.full((3, B, L), BIG, dtype=torch.int32, device=dev)
    col0[2] = go + torch.cumsum(ins, 1, dtype=torch.int32)
    to_y = torch.tensor([go, go, 0], dtype=torch.int32, device=dev).view(3, 1, 1)
    to_x = torch.tensor([go, 0, go], dtype=torch.int32, device=dev).view(3, 1, 1)

    ends = {}
    for k, d in enumerate((m + n).tolist()):
        ends.setdefault(d, []).append(k)
    ends = {d: (torch.tensor(ks, device=dev), m[ks].long()) for d, ks in ends.items()}
    final = torch.empty((B, 3), dtype=torch.int32, device=dev)
    codes = (torch.empty((D, B, L), dtype=torch.uint8, device=dev)
             if want_codes else None)

    prev = torch.full((3, B, L), BIG, dtype=torch.int32, device=dev)
    prev[:, :, 0] = 0  # diagonal 0: cell (0, 0)
    best2 = torch.full((B, L), BIG, dtype=torch.int32, device=dev)  # d-2
    arg2 = torch.zeros((B, L), dtype=torch.int64, device=dev)
    best1, arg1 = prev.min(0)
    for d in range(1, D):
        at = T - 1 - L - d
        sub = torch.take(flat, a_row + rev[:, at:at + L])
        y_from, arg_y = (prev + to_y).min(0)
        x_from, arg_x = (prev + to_x).min(0)
        cur = torch.empty_like(prev)
        torch.add(best2[:, :-1], sub[:, 1:], out=cur[0, :, 1:])
        torch.add(x_from, rev_del[:, at:at + L], out=cur[1])
        torch.add(y_from[:, :-1], ins[:, 1:], out=cur[2, :, 1:])
        cur[:, :, 0] = row0[:, :, d]
        if d <= Mx:
            cur[:, :, d] = col0[:, :, d]
        best, arg = cur.min(0)
        if want_codes:
            code = arg_x * 4
            code[:, 1:] += arg2[:, :-1] + 16 * arg_y[:, :-1]
            codes[d] = code
        if d in ends:
            ks, rows = ends[d]
            final[ks] = cur[:, ks, rows].T
        prev, best2, arg2, best1, arg1 = cur, best1, arg1, best, arg
    return final, codes


def _walk(codes, final, m, n):
    """The walk of every pair of a group: (B, T) steps from (m, n), each the
    level it leaves (DIAG, LEFT or UP), DONE past the pair's end."""
    dev = final.device
    D, B, L = codes.shape
    # The start level: the first minimum of final, M before Ix before Iy.
    level = final.min(1).indices
    i, j = m.long().clone(), n.long().clone()
    steps = int((m + n).max())
    tape = torch.full((B, max(steps, 1)), DONE, dtype=torch.uint8, device=dev)
    flat = codes.view(-1)
    lanes = torch.arange(B, device=dev) * L
    for t in range(steps):
        if t % 512 == 0 and not bool(((i + j) > 0).any()):
            break
        live = (i + j) > 0
        top, left_edge = i == 0, j == 0
        step = torch.where(top, LEFT, torch.where(left_edge, UP, level))
        code = torch.take(flat, ((i + j).clamp_(max=D - 1) * (B * L) + lanes) + i)
        level = torch.where(top | left_edge, level, (code >> (2 * level)) & 3)
        tape[:, t] = torch.where(live, step, DONE)
        i = i - (live & (step != LEFT)).long()
        j = j - (live & (step != UP)).long()
    return tape


def _render(tape, seq_1: list[str], seq_2: list[str]):
    """Three lines a pair from its walk (taken from the end backwards)."""
    tape = tape.cpu().numpy()
    count = (tape != DONE).sum(1)
    width = tape.shape[1]
    back = count[:, None] - 1 - np.arange(width)[None, :]
    steps = np.take_along_axis(tape, back.clip(0), 1)
    out = []
    for k, (s1, s2) in enumerate(zip(seq_1, seq_2)):
        s = steps[k, :count[k]]
        use_1, use_2 = s != LEFT, s != UP
        x = np.frombuffer(s1.encode("ascii"), np.uint8)
        y = np.frombuffer(s2.encode("ascii"), np.uint8)
        line_1 = np.full(len(s), ord("-"), np.uint8)
        line_2 = line_1.copy()
        line_1[use_1] = x[: int(use_1.sum())]
        line_2[use_2] = y[: int(use_2.sum())]
        mid = np.full(len(s), ord(" "), np.uint8)
        diag = s == DIAG
        mid[diag] = np.where(line_1[diag] == line_2[diag], ord("|"), ord("*"))
        out.append((line_1.tobytes().decode(), mid.tobytes().decode(),
                    line_2.tobytes().decode()))
    return out


def _groups(m: np.ndarray, n: np.ndarray, budget: int, max_pairs: int):
    """Indices of pairs in groups, by size, each group's codes under
    ``budget`` bytes."""
    order = np.argsort(m + n, kind="stable")
    groups, cur, mx, nx = [], [], 0, 0
    for k in order.tolist():
        m2, n2 = max(mx, int(m[k])), max(nx, int(n[k]))
        if cur and ((len(cur) + 1) * (m2 + n2 + 1) * (m2 + 1) > budget
                    or len(cur) == max_pairs):
            groups.append(cur)
            cur, m2, n2 = [], int(m[k]), int(n[k])
        cur.append(k)
        mx, nx = m2, n2
    if cur:
        groups.append(cur)
    return groups


def align(pairs: Sequence[tuple[str, str]], costing: Costing, *,
          traceback: bool = True, device="cpu",
          budget_bytes: int = 1 << 30, max_pairs: int = 2048):
    """(cost, score, seq_1 line, middle line, seq_2 line) of every pair, the
    lines None without ``traceback``."""
    lut = costing.lut()
    m = np.array([len(s1) for s1, _ in pairs], np.int64)
    n = np.array([len(s2) for _, s2 in pairs], np.int64)
    out = [None] * len(pairs)
    for group in _groups(m, n, budget_bytes, max_pairs):
        Mx, Nx = int(m[group].max()), int(n[group].max())
        a = np.zeros((len(group), Mx + 1), np.int64)
        b = np.zeros((len(group), Nx + 1), np.int64)
        for row, k in enumerate(group):
            s1, s2 = pairs[k]
            a[row, 1:len(s1) + 1] = lut[np.frombuffer(s1.encode("ascii"), np.uint8)]
            b[row, 1:len(s2) + 1] = lut[np.frombuffer(s2.encode("ascii"), np.uint8)]
        if (a < 0).any() or (b < 0).any():
            raise ValueError("a letter outside the scheme")
        mg = torch.as_tensor(m[group], device=device)
        ng = torch.as_tensor(n[group], device=device)
        final, codes = _group_fill(torch.as_tensor(a, device=device),
                                   torch.as_tensor(b, device=device), mg, ng,
                                   costing, traceback)
        costs = final.min(1).values.tolist()
        lines = [(None, None, None)] * len(group)
        if traceback:
            tape = _walk(codes, final, mg, ng)
            del codes
            lines = _render(tape, [pairs[k][0] for k in group],
                            [pairs[k][1] for k in group])
        for k, c, ls in zip(group, costs, lines):
            out[k] = (c, costing.score(c, int(m[k]), int(n[k])), *ls)
    return out
