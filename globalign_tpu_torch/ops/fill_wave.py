"""Anti-diagonal meet-in-the-middle cost for uniform schemes.

The port of ``globalign_tpu/ops/fill_pallas.py:wave_split_fill_cost``
(:1690) and its TPU kernel ``_make_wave_kernel`` (:1510).  Two problems
are filled by anti-diagonal waves, side by side: the pair forward to wave
T = (m+n)//2, and both sequences reversed to wave tmax = m+n-T+1.  Each
captures two waves — forward T-1 and T, reversed tmax-1 and tmax — and
the optimal cost is the Myers-Miller join over the crossing anti-diagonal,
in plain torch outside the kernel, as the JAX package joins outside its
Pallas kernel:

  * a path whose last cell on a wave <= T lies ON wave T crosses at some
    (i, T-i), arriving in level L and leaving in L':
    ``F_L(i, T-i) + G_L'(m-i, n-T+i) - go * [L == L' in {Ix, Iy}]``;
  * otherwise it jumps from wave T-1 to T+1 with a diagonal move:
    ``F_L(i, T-1-i) + G_M(m-i, n-T+1+i)`` (G_M's first move is that
    diagonal).

Uniform schemes only (one match, one mismatch, one deletion and one
insertion cost: ``uniform_scheme_params``), so a substitution is one
compare and select and the row-0 / column-0 boundaries are the closed
forms ``go + t*d`` / ``go + t*ic``.

``wave_frontiers`` computes the captured waves: on CUDA tensors one launch
of ``csrc/wave_split.cu``, on CPU tensors the plain version, the same
recurrence as a loop over waves vectorised over DP rows.  There is no
other route: a CUDA tensor the kernel cannot take raises.  The kernel
fills both problems' triangles i + j <= cap as tiles of 32 W columns by H
rows (``plan``), a warp a tile, in the ticket order of ``tile_order``;
the tiles hand their edges on through buffers the wrapper allocates.

The reference is wrong when m + n <= 1 ((0, 0) gives -4, (0, 1) and
(1, 0) give 3).  There the crossing wave T = 0 is the (0, 0) corner,
whose (0, 0, 0) lanes hold no gap run, so the gap-open correction on
L = L' in {Ix, Iy} undercounts by go; and its capture wave T - 1 = -1 is
never written by the TPU kernel.  Here a capture wave before wave 0 is
defined (all BIG), and the join masks the corner's Ix / Iy lanes, as
``ops.fill_split`` masks a zero-row half's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .fill_scan import BIG

WARP = 32
WIDTH = 4  # W, columns a lane, fixed in the kernel: tiles of 32 W x 32 W
EDGE_BYTES = 16  # an edge cell in the buffers: (M, Ix, Iy, unused) int32
FLAG_STRIDE = 32  # int32 a flag: one 128-byte line each


def uniform_scheme_params(cost_mat, gap_id) -> tuple[int, int, int, int] | None:
    """(cmatch, cmismatch, dcost, icost) if the costing matrix is uniform
    (one match cost, one mismatch cost, one gap-extension cost per
    direction — the reference's simple-scheme family), else None."""
    cm = np.asarray(cost_mat)
    g = int(gap_id)
    idx = [c for c in range(cm.shape[0]) if c != g]
    if not idx:
        return None
    sub = cm[np.ix_(idx, idx)]
    diag = np.diag(sub)
    off = sub[~np.eye(len(idx), dtype=bool)]
    drow = cm[g, idx]
    icol = cm[idx, g]
    if len(set(diag.tolist())) != 1:
        return None
    if off.size and len(set(off.tolist())) != 1:
        return None
    if len(set(drow.tolist())) != 1 or len(set(icol.tolist())) != 1:
        return None
    cmatch = int(diag[0])
    cmismatch = int(off[0]) if off.size else cmatch
    return cmatch, cmismatch, int(drow[0]), int(icol[0])


def capture_waves(m: int, n: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The waves each problem captures: forward (T-1, T), reversed
    (tmax-1, tmax), with T = (m+n)//2 and tmax = m+n-T+1."""
    t_split = (m + n) // 2
    tmax = m + n - t_split + 1
    return (t_split - 1, t_split), (tmax - 1, tmax)


class WavePlan(NamedTuple):
    """The kernel's tiling of an m x n pair: W columns a lane, H rows a
    tile, the tiles of both problems' triangles (tickets), and the bytes
    of the buffers the wrapper allocates beside the output (edges, flags,
    the ticket table)."""

    width: int
    height: int
    tiles: int
    scratch_bytes: int


def tile_grid(m: int, n: int, width: int, height: int) -> tuple[int, int]:
    """(B, C): tile rows over DP rows 1..m, tile columns over 1..n."""
    return -(-m // height), -(-n // (WARP * width))


@functools.lru_cache(maxsize=8)
def tile_order(m: int, n: int, width: int, height: int) -> np.ndarray:
    """The kernel's ticket table: (tiles, 2) int32 rows (2 b + p, c), one
    for tile (b, c) of problem p, in the order warps take them.

    Tile (b, c) covers rows b*H+1 .. (b+1)*H and columns c*32W+1 ..
    (c+1)*32W.  A problem's tile is in the table iff its first cell lies
    on or before the problem's last capture wave (b*H + c*32W + 2 <=
    cap); those are the tiles the triangle reaches, and a tile's producers
    (b-1, c) and (b, c-1) are among them.  Order: tile anti-diagonal b + c,
    then b, then the problem, so a tile's producers hold smaller tickets.
    The array is read-only (cached)."""
    B, C = tile_grid(m, n, width, height)
    b, c = np.meshgrid(np.arange(B), np.arange(C), indexing="ij")
    b, c = b.ravel(), c.ravel()
    first = b * height + c * (WARP * width) + 2
    rows = []
    for p, (_, cap) in enumerate(capture_waves(m, n)):
        keep = first <= cap
        rows.append(np.stack([b[keep], c[keep], np.full(keep.sum(), p)], 1))
    t = np.concatenate(rows)
    t = t[np.lexsort((t[:, 2], t[:, 0], t[:, 0] + t[:, 1]))]
    out = np.stack([2 * t[:, 0] + t[:, 2], t[:, 1]], 1).astype(np.int32)
    out.flags.writeable = False
    return out


def plan(m: int, n: int) -> WavePlan:
    """The tiling ``wave_frontiers`` launches for an m x n pair: square
    tiles (the kernel's), so the critical path of tiles runs as fast down
    as across."""
    width, height = WIDTH, WARP * WIDTH
    B, C = tile_grid(m, n, width, height)
    tiles = len(tile_order(m, n, width, height))
    scratch = (
        2 * (C * WARP * width + 1) * EDGE_BYTES  # row buffers
        + 2 * B * (height + 1) * EDGE_BYTES  # column buffers
        + 4 * FLAG_STRIDE * (1 + 2 * C)  # the ticket counter, column flags
        + 8 * tiles  # the ticket table
    )
    return WavePlan(width, height, tiles, scratch)


@functools.lru_cache(maxsize=4)
def _device_order(m, n, width, height, device) -> torch.Tensor:
    return torch.from_numpy(tile_order(m, n, width, height).copy()).to(device)


def _check(tok_a, tok_b, m_true, n_true):
    for name, x in (("tok_a", tok_a), ("tok_b", tok_b)):
        if x.dim() != 1 or x.shape[0] < 1:
            raise ValueError(f"{name} must be a non-empty 1-D token buffer")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tok_b.device != tok_a.device:
        raise ValueError(f"tok_b is on {tok_b.device}, tok_a on {tok_a.device}")
    m, n = int(m_true), int(n_true)
    if not (0 <= m < tok_a.shape[0] and 0 <= n < tok_b.shape[0]):
        raise ValueError(
            f"true lengths ({m}, {n}) outside the buffers "
            f"({tok_a.shape[0] - 1}, {tok_b.shape[0] - 1})"
        )
    return m, n


def _plain(tok_a, tok_b, cmatch, cmismatch, dcost, icost, gap_open, m, n):
    """The kernel's plain version: the wave recurrence, one wave a step,
    vectorised over the DP rows of both problems.

    Row i of wave t is the cell (i, t-i).  Only the rows the wave reaches,
    i in [max(0, t-n), min(t, m)], are computed; a captured wave is BIG at
    every other row (i > t, i > m or t-i > n).  State per row: the lanes of
    the wave before and the min3 of the wave before that, with a BIG
    sentinel row -1 at index 0.
    """
    dev = tok_a.device
    rows = tok_a.shape[0]
    caps = capture_waves(m, n)
    go, d, ic = int(gap_open), int(dcost), int(icost)
    out = torch.full((2, 2, 3, rows), BIG, dtype=torch.int32, device=dev)

    ii = torch.arange(m + 1, device=dev)
    jj = torch.arange(n + 1, device=dev)
    a_tok = torch.stack([tok_a[ii], tok_a[(m + 1 - ii).clamp(0, m)]])
    b_tok = torch.stack([tok_b[jj], tok_b[(n + 1 - jj).clamp(0, n)]])
    state = torch.full((4, 2, m + 2), BIG, dtype=torch.int32, device=dev)
    state[:3, :, 1] = 0  # wave 0: the (0, 0) corner
    for p in range(2):
        for k in range(2):
            if caps[p][k] == 0:
                out[p, k, :, 0] = 0

    for t in range(1, caps[1][1] + 1):
        lo, hi = max(0, t - n), min(t, m)
        own = state[:, :, lo + 1 : hi + 2]  # rows lo..hi after wave t-1
        prev = state[:, :, lo : hi + 1]  # rows lo-1..hi-1
        sub = torch.where(
            a_tok[:, lo : hi + 1] == b_tok[:, t - hi : t - lo + 1].flip(-1),
            cmatch, cmismatch,
        )
        new = torch.stack([
            torch.clamp(prev[3] + sub, max=BIG),
            torch.clamp(
                torch.minimum(torch.minimum(own[0], own[2]) + go, own[1]) + d,
                max=BIG,
            ),
            torch.clamp(
                torch.minimum(torch.minimum(prev[0], prev[1]) + go, prev[2])
                + ic,
                max=BIG,
            ),
            torch.minimum(torch.minimum(own[0], own[1]), own[2]),
        ]).to(torch.int32)
        if lo == 0:  # row 0: (BIG, go + t*d, BIG)
            new[0, :, 0], new[1, :, 0], new[2, :, 0] = BIG, go + t * d, BIG
        if hi == t:  # column 0: (BIG, BIG, go + t*ic)
            new[0, :, -1], new[1, :, -1], new[2, :, -1] = BIG, BIG, go + t * ic
        state[:, :, lo + 1 : hi + 2] = new
        for p in range(2):
            for k in range(2):
                if caps[p][k] == t:
                    out[p, k, :, lo : hi + 1] = new[:3, p]
    return out


def wave_frontiers(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cmatch: int,
    cmismatch: int,
    dcost: int,
    icost: int,
    gap_open: int,
    m_true: int,
    n_true: int,
) -> torch.Tensor:
    """The captured waves of both problems: (2, 2, 3, M+1) int32,
    [problem][capture k][lane M, Ix, Iy][DP row i].

    Problem 0 is the pair forward, problem 1 both sequences reversed
    (row i of problem 1 holds seq_1's token m+1-i, column j seq_2's
    n+1-j).  Captures are ``capture_waves(m, n)``; wave 0 is the corner
    (0, 0, 0) at row 0, a wave before it is all BIG, and every row a wave
    does not reach (i > t, i > m, t-i > n) is BIG.

    Args:
        tok_a / tok_b: (M+1,) / (N+1,) int32 contiguous 1-origin tokens
            (entry 0 unused; padding past m_true / n_true allowed), on the
            CPU or on a CUDA device.
        cmatch..icost / gap_open: the uniform scheme's costs, host ints.
        m_true / n_true: the true lengths, host ints.

    ``wave_frontiers.launches`` counts kernel launches.
    """
    m, n = _check(tok_a, tok_b, m_true, n_true)
    costs = [int(c) for c in (cmatch, cmismatch, dcost, icost, gap_open)]
    device = tok_a.device
    if device.type == "cpu":
        return _plain(tok_a, tok_b, *costs, m, n)
    if device.type != "cuda":
        raise ValueError(f"no wave_split route for device {device}")

    from ..utils import cuda_build

    lib = cuda_build.load()
    pl = plan(m, n)
    B, C = tile_grid(m, n, pl.width, pl.height)
    (f0, f1), (r0, r1) = capture_waves(m, n)
    with torch.cuda.device(device):
        order = _device_order(m, n, pl.width, pl.height, device)
        out = torch.empty((2, 2, 3, tok_a.shape[0]), dtype=torch.int32,
                          device=device)
        rowbuf = torch.empty((2, C * WARP * pl.width + 1, EDGE_BYTES // 4),
                             dtype=torch.int32, device=device)
        colbuf = torch.empty((2, B, pl.height + 1, EDGE_BYTES // 4),
                             dtype=torch.int32, device=device)
        flags = torch.zeros(FLAG_STRIDE * (1 + 2 * C), dtype=torch.int32,
                            device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        wave_frontiers.launches += 1
        err = lib.wave_split_launch(
            tok_a.data_ptr(), tok_b.data_ptr(), out.data_ptr(),
            order.data_ptr(), rowbuf.data_ptr(), colbuf.data_ptr(),
            flags.data_ptr(), tok_a.shape[0], m, n, *costs, f0, f1, r0, r1,
            pl.tiles, stream,
        )
    if err != 0:
        msg = lib.wave_split_error_string(err).decode()
        raise RuntimeError(f"wave_split launch failed: CUDA error {err} ({msg})")
    return out


def wave_split_fill_cost(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cmatch: int,
    cmismatch: int,
    dcost: int,
    icost: int,
    gap_open: int,
    m_true: int,
    n_true: int,
) -> torch.Tensor:
    """Optimal cost of aligning tok_a[1:m+1] with tok_b[1:n+1] under a
    uniform scheme, for any m, n >= 0: a 0-d int32 tensor on the tokens'
    device.  Arguments as in :func:`wave_frontiers`."""
    m, n = _check(tok_a, tok_b, m_true, n_true)
    frontiers = wave_frontiers(
        tok_a, tok_b, cmatch, cmismatch, dcost, icost, gap_open, m, n
    )
    return join_frontiers(frontiers, gap_open, m, n)


def join_frontiers(frontiers: torch.Tensor, gap_open: int, m: int, n: int):
    """The optimal cost from :func:`wave_frontiers`' captured waves: the
    join over the crossing anti-diagonal (module docstring), in plain torch
    on the frontiers' device, as ``fill_pallas.py:1780-1808`` joins."""
    go = int(gap_open)
    t_split = (m + n) // 2
    width = frontiers.shape[-1]
    f1, f2 = frontiers[0, 0], frontiers[0, 1]  # forward waves T-1, T
    ivec = torch.arange(width, device=frontiers.device)
    flip = (m - ivec).clamp(0, width - 1)
    g1 = frontiers[1, 0][:, flip]  # reversed waves, by forward row
    g2 = frontiers[1, 1][:, flip]

    half_big = BIG // 2
    valid1 = (ivec >= t_split - n) & (ivec <= min(t_split, m))
    f2m = torch.where(valid1, f2.clamp(max=half_big), half_big)
    g1m = torch.where(valid1, g1.clamp(max=half_big), half_big)
    # The corner (0, 0) holds (0, 0, 0) in all three lanes, but no gap run
    # reaches it: its Ix / Iy "levels" are fictitious, so mask them lest
    # the gap-open correction undercount (wave T is the corner when
    # m + n <= 1, the reversed wave m+n-T when m + n == 0).
    if t_split == 0:
        f2m[1:, 0] = half_big
    if m + n - t_split == 0:
        g1m[1:, 0] = half_big
    combo = f2m[:, None, :] + g1m[None, :, :]  # (L, L', i)
    combo[1, 1] -= go
    combo[2, 2] -= go
    term1 = combo.min()

    valid2 = (ivec >= t_split - 1 - n) & (ivec <= min(t_split - 1, m))
    f1m = torch.where(valid2, f1.clamp(max=half_big), half_big)
    g2m = torch.where(valid2, g2[0].clamp(max=half_big), half_big)
    term2 = (f1m + g2m[None, :]).min()
    return torch.minimum(term1, term2)


wave_frontiers.launches = 0
