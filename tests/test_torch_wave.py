"""The anti-diagonal split cost and the dual-set batch fill, held against
the JAX package on the CPU.

``globalign_tpu_torch.ops.fill_wave`` on CPU tensors (the wave kernel's
plain version and the join) against JAX ``wave_split_fill_cost`` (TPU
kernel ``_make_wave_kernel`` in interpret mode) on the JAX tests' cases,
against the direct fill on every (m, n) in 0..5 x 0..5, and its captured
waves against the row scan's DP planes; the CUDA kernel's tiling (``plan``),
its ticket table (``tile_order``) and its tile schedule, emulated in Python
at tiny tiles, against the plain version; ``ops.fill_batch.batch_final3_dual``
against JAX ``lanes_batch_final3_dual`` / ``lanes_general_final3_dual``
(TPU kernel ``_make_lane_kernel(npar=2)``, interpret mode).

Tolerance 0: costs and DP lanes are integers.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalign_tpu.config import resolve_scheme as jax_resolve_scheme
from globalign_tpu.ops import fill_lanes, fill_pallas
from globalign_tpu.ops.transforms import scoring_mat_to_costing_mat
from globalign_tpu.utils.matrices import create_scoring_mat, load_bundled_matrix
from globalign_tpu.utils.tokenize import Alphabet, encode_padded
from globalign_tpu_torch.ops import fill_batch, fill_rows, fill_wave
from globalign_tpu_torch.ops.fill_scan import BIG

ALPHA = Alphabet.from_letters(("A", "C", "G", "T", "-"))
# tests/test_fill_pallas.py's scheme: scoring 2 / -3 / -2, max score 2,
# gap open 4 (the JAX bench's wave arm, bench.py:244-251).
BENCH_COST = np.asarray(
    scoring_mat_to_costing_mat(create_scoring_mat(ALPHA, 2, -3, -2), max_score=2).values,
    np.int32,
)
BENCH_GO = 4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _jax_cases():
    """tests/test_fill_pallas.py:361-437's pairs: 14 random pairs of 2-70
    from default_rng(83), the gap-run extremes, the tiny pairs."""
    rng = np.random.default_rng(83)
    cases = []
    for _ in range(14):
        m = int(rng.integers(2, 70))
        n = int(rng.integers(2, 70))
        cases.append(("".join(rng.choice(list("ACGT"), m)),
                      "".join(rng.choice(list("ACGT"), n))))
    cases += [("AC", "AC" + "G" * 50), ("AC" + "G" * 50, "AC"),
              ("A" * 40, "A" * 3), ("GATTACA", "GATTACA")]
    cases += [("A", "C"), ("A", "A"), ("AC", "G"), ("G", "AC"), ("A", "CG")]
    return cases


def _direct(ta, tb, cm, gid, go, m, n):
    return int(fill_rows.row_fill(_t(ta), _t(tb), _t(cm), gid, go, m, n,
                                  want_moves=False).final3.min())


def _both(ta, tb, cm, gid, go, m, n):
    """(port plain, JAX interpret) costs on the same padded buffers."""
    prm = fill_wave.uniform_scheme_params(cm, gid)
    got = int(fill_wave.wave_split_fill_cost(_t(ta), _t(tb), *prm, go, m, n))
    want = int(fill_pallas.wave_split_fill_cost(
        jnp.asarray(ta), jnp.asarray(tb), *prm, go, m, n, interpret=True
    ))
    return got, want


@pytest.mark.parametrize("s1,s2", _jax_cases())
def test_wave_split_cost_matches_jax(s1, s2):
    m, n = len(s1), len(s2)
    ta = encode_padded(ALPHA, s1, 16 * -(-m // 16))
    tb = encode_padded(ALPHA, s2, 16 * -(-n // 16))
    got, want = _both(ta, tb, BENCH_COST, ALPHA.gap_id, BENCH_GO, m, n)
    assert got == want == _direct(ta, tb, BENCH_COST, ALPHA.gap_id, BENCH_GO, m, n)


@pytest.mark.parametrize("mmc,go,ge", [(5, 4, 3), (1, 7, 1), (9, 2, 6)])
def test_wave_split_cost_matches_jax_across_schemes(mmc, go, ge):
    """tests/test_fill_pallas.py:469's fuzz schemes, its pairs."""
    rng = np.random.default_rng(mmc * 100 + go * 10 + ge)
    s1 = "".join(rng.choice(list("ACGT"), 57))
    s2 = "".join(rng.choice(list("ACGT"), 43))
    scheme = jax_resolve_scheme(s1, s2, mismatch_cost=mmc, gap_open_cost=go,
                                gap_extension_cost=ge)
    cm = np.asarray(scheme.costing.values, np.int32)
    gid = scheme.alphabet.gap_id
    ta = encode_padded(scheme.alphabet, s1, 64)
    tb = encode_padded(scheme.alphabet, s2, 64)
    got, want = _both(ta, tb, cm, gid, go, len(s1), len(s2))
    assert got == want == _direct(ta, tb, cm, gid, go, len(s1), len(s2))


@pytest.mark.parametrize("m,n", list(itertools.product(range(6), range(6))))
def test_wave_split_cost_equals_the_direct_fill(m, n):
    """Every (m, n) in 0..5 x 0..5, three random pairs each, under the
    scheme of the reference fault (mismatch 5, gap open 4, extension 3),
    token buffers padded past the true lengths."""
    scheme = jax_resolve_scheme("ACGT", "ACGT", mismatch_cost=5,
                                gap_open_cost=4, gap_extension_cost=3)
    cm = np.asarray(scheme.costing.values, np.int32)
    gid = scheme.alphabet.gap_id
    prm = fill_wave.uniform_scheme_params(cm, gid)
    rng = np.random.default_rng(100 * m + n)
    for _ in range(3):
        ta = np.concatenate([[0], rng.integers(0, 4, m + 2)]).astype(np.int32)
        tb = np.concatenate([[0], rng.integers(0, 4, n + 1)]).astype(np.int32)
        got = int(fill_wave.wave_split_fill_cost(_t(ta), _t(tb), *prm, 4, m, n))
        assert got == _direct(ta, tb, cm, gid, 4, m, n)


@pytest.mark.parametrize("m,n,right,reference", [
    (0, 0, 0, -4), (0, 1, 7, 3), (1, 0, 7, 3),
])
def test_the_reference_fault_at_m_plus_n_at_most_one_is_not_copied(
    m, n, right, reference
):
    """JAX ``wave_split_fill_cost`` is wrong when m + n <= 1: the crossing
    wave is the (0, 0) corner, whose Ix / Iy lanes take the gap-open
    correction.  The port gives the direct fill's cost."""
    scheme = jax_resolve_scheme("ACGT", "ACGT", mismatch_cost=5,
                                gap_open_cost=4, gap_extension_cost=3)
    cm = np.asarray(scheme.costing.values, np.int32)
    gid = scheme.alphabet.gap_id
    ta = np.array([0, 1, 0, 0][: m + 2], np.int32)
    tb = np.array([0, 2, 0][: n + 2], np.int32)
    got, want = _both(ta, tb, cm, gid, 4, m, n)
    assert got == right == _direct(ta, tb, cm, gid, 4, m, n)
    assert want == reference


def _assert_frontier_matches_planes(out_p, ta, tb, cm, gid, go, m, n, waves):
    """Each captured wave equals the row scan's planes at its reached rows
    (i, t-i), max(0, t-n) <= i <= min(t, m), and is BIG at every other."""
    planes = fill_rows.row_fill(_t(ta), _t(tb), _t(cm), gid, go, m, n,
                                want_moves=False, want_planes=True).planes
    for k, t in enumerate(waves):
        for i in range(out_p.shape[-1]):
            got = out_p[k, :, i].tolist()
            if t >= 0 and max(0, t - n) <= i <= min(t, m):
                assert got == planes[:, i, t - i].tolist(), (k, t, i)
            else:
                assert got == [BIG] * 3, (k, t, i)


@pytest.mark.parametrize("m,n", [(0, 0), (1, 0), (0, 3), (1, 1), (9, 4), (5, 23),
                                 (31, 30)])
def test_wave_frontiers_equal_the_row_scan_planes(m, n):
    """The forward frontier is the pair's DP at waves T-1 and T; the
    reversed frontier is the reversed pair's DP at waves tmax-1 and tmax
    (buffers padded by two rows and one column)."""
    rng = np.random.default_rng(7 * m + n)
    ta = np.concatenate([[0], rng.integers(0, 4, m + 2)]).astype(np.int32)
    tb = np.concatenate([[0], rng.integers(0, 4, n + 1)]).astype(np.int32)
    gid = ALPHA.gap_id
    prm = fill_wave.uniform_scheme_params(BENCH_COST, gid)
    out = fill_wave.wave_frontiers(_t(ta), _t(tb), *prm, BENCH_GO, m, n)
    assert out.shape == (2, 2, 3, m + 3) and out.dtype == torch.int32
    fwd, rev = fill_wave.capture_waves(m, n)
    _assert_frontier_matches_planes(out[0], ta, tb, BENCH_COST, gid, BENCH_GO,
                                    m, n, fwd)
    ta_r = np.concatenate([[0], ta[1 : m + 1][::-1]])
    tb_r = np.concatenate([[0], tb[1 : n + 1][::-1]])
    _assert_frontier_matches_planes(out[1, :, :, : m + 1], ta_r, tb_r,
                                    BENCH_COST, gid, BENCH_GO, m, n, rev)


@pytest.mark.parametrize("kw", [
    {}, dict(match_score=3, mismatch_score=-2, gap_open_score=-5,
             gap_extension_score=-1),
    dict(mismatch_cost=9, gap_open_cost=2, gap_extension_cost=6),
])
def test_uniform_scheme_params_match_jax(kw):
    scheme = jax_resolve_scheme("ACGT", "ACGTT", **kw)
    cm = np.asarray(scheme.costing.values)
    gid = scheme.alphabet.gap_id
    want = fill_pallas.uniform_scheme_params(cm, gid)
    assert want is not None
    assert fill_wave.uniform_scheme_params(cm, gid) == want
    assert fill_wave.uniform_scheme_params(_t(cm), gid) == want


def test_uniform_scheme_params_declines_blosum62():
    scoring = load_bundled_matrix("BLOSUM62")
    b62 = scoring_mat_to_costing_mat(scoring, max_score=int(scoring.values.max()))
    assert fill_pallas.uniform_scheme_params(b62.values, b62.alphabet.gap_id) is None
    assert fill_wave.uniform_scheme_params(b62.values, b62.alphabet.gap_id) is None


def test_wave_frontiers_check_inputs_and_have_no_other_route():
    ta = torch.zeros(5, dtype=torch.int32)
    tb = torch.zeros(3, dtype=torch.int32)
    prm = (0, 5, 3, 3, 4)
    assert fill_wave.wave_split_fill_cost(ta, tb, *prm, 4, 2).dim() == 0
    with pytest.raises(ValueError, match="outside the buffers"):
        fill_wave.wave_frontiers(ta, tb, *prm, 5, 2)
    with pytest.raises(TypeError, match="int32"):
        fill_wave.wave_frontiers(ta.long(), tb, *prm, 4, 2)
    with pytest.raises(ValueError, match="1-D"):
        fill_wave.wave_frontiers(ta[None], tb, *prm, 0, 2)
    meta = [torch.zeros(x.shape, dtype=torch.int32, device="meta") for x in (ta, tb)]
    before = fill_wave.wave_frontiers.launches
    with pytest.raises(ValueError, match="no wave_split route"):
        fill_wave.wave_frontiers(*meta, *prm, 4, 2)
    with pytest.raises(ValueError, match="tok_b is on"):
        fill_wave.wave_frontiers(ta, meta[1], *prm, 4, 2)
    assert fill_wave.wave_frontiers.launches == before


# (W, H, tiles, scratch bytes): 128 x 128 tiles; tiles = both problems'
# (b, c) with 128 (b + c) + 2 <= cap; scratch = row buffers 2 (128 C + 1)
# x 16 + column buffers 2 B 129 x 16 + flags 128 (1 + 2 C) + table 8 tiles.
@pytest.mark.parametrize("m,n,want", [
    (0, 0, (4, 128, 0, 160)),
    (32, 0, (4, 128, 0, 4288)),
    (1, 1, (4, 128, 1, 8648)),  # forward T = 1: its tile starts on wave 2
    (31, 32, (4, 128, 2, 8656)),
    (1024, 31, (4, 128, 10, 37_616)),
    (1024, 1024, (4, 128, 72, 68_576)),
    (50_000, 1, (4, 128, 392, 1_621_696)),
    (1, 50_000, (4, 128, 392, 1_709_056)),
    (12_345, 3000, (4, 128, 2328, 523_648)),
    (3000, 12_345, (4, 128, 2328, 540_000)),
    (50_000, 50_000, (4, 128, 153_272, 4_542_016)),
])
def test_wave_kernel_plan(m, n, want):
    pl = fill_wave.plan(m, n)
    assert tuple(pl) == want
    assert pl.width * fill_wave.WARP == pl.height  # square tiles


def _order_shapes():
    rng = np.random.default_rng(9)
    shapes = [(0, 0), (0, 5), (5, 0), (1, 1), (2, 1), (31, 30), (96, 95),
              (97, 1), (1, 97), (200, 40), (40, 200)]
    shapes += [tuple(int(x) for x in rng.integers(0, 300, 2)) for _ in range(6)]
    return shapes


@pytest.mark.parametrize("width,height", [(1, 3), (1, 32), (2, 5), (4, 128)])
@pytest.mark.parametrize("m,n", _order_shapes())
def test_tile_order_is_a_schedule_of_the_triangles(m, n, width, height):
    """Every tile the triangle reaches appears once, no tile past the last
    capture wave or past (m, n), and each tile's top and left producers
    come before it."""
    order = fill_wave.tile_order(m, n, width, height)
    bw = fill_wave.WARP * width
    tiles = [(int(x) & 1, int(x) >> 1, int(c)) for x, c in order]
    assert len(set(tiles)) == len(tiles)
    caps = [cap for _, cap in fill_wave.capture_waves(m, n)]
    reached = {
        (p, (i - 1) // height, (j - 1) // bw)
        for p in range(2) for i in range(1, m + 1) for j in range(1, n + 1)
        if i + j <= caps[p]
    }
    assert set(tiles) == reached
    rank = {t: k for k, t in enumerate(tiles)}
    for (p, b, c), k in rank.items():
        assert (b == 0 or rank[(p, b - 1, c)] < k) and (c == 0 or rank[(p, b, c - 1)] < k)
    diag = [b + c for _, b, c in tiles]
    assert diag == sorted(diag)
    assert fill_wave.plan(m, n).tiles == len(fill_wave.tile_order(
        m, n, fill_wave.WIDTH, fill_wave.WARP * fill_wave.WIDTH))


# -- the kernel's tile schedule, emulated ------------------------------------

_GARBAGE = -777  # what an edge buffer holds before a tile writes it


def _emulate_kernel(ta, tb, costs, m, n, width, height, order):
    """csrc/wave_split.cu's schedule in Python: the boundary rows, then the
    tiles in ticket order, a warp's 32 lanes skewed a row apart (a lane's
    left cell is the left lane's last cell of the step before, lane 0's
    the staged left edge), captures written by the lane that owns column
    cap - i, and after a tile's steps its edges handed on through one row
    buffer and one column buffer (slot 0 the corner) a problem: the bottom
    row from the lanes in use, the right column and corner only when all
    32 lanes are in use.  Python ints; the kernel's integer operations."""
    cmatch, cmismatch, d, ic, go = costs
    R = len(ta)
    bw = fill_wave.WARP * width
    B, C = fill_wave.tile_grid(m, n, width, height)
    caps = fill_wave.capture_waves(m, n)
    out = np.full((2, 2, 3, R), -999, np.int64)  # -999: never written
    for p in range(2):
        for k in range(2):
            for i in range(R):
                j = caps[p][k] - i
                if 1 <= i <= m and 1 <= j <= n:
                    continue
                v = (BIG, BIG, BIG)
                if i <= m and 0 <= j <= n:
                    v = ((0, 0, 0) if i == j == 0 else (BIG, go + j * d, BIG)
                         if i == 0 else (BIG, BIG, go + i * ic))
                out[p, k, :, i] = v
    rowbuf = np.full((2, C * bw + 1, 3), _GARBAGE, np.int64)
    colbuf = np.full((2, B, height + 1, 3), _GARBAGE, np.int64)
    done = np.zeros((2, C), np.int64)
    for code, c in order:
        p, b = int(code) & 1, int(code) >> 1
        c = int(c)
        assert (c == 0 or done[p, c - 1] >= b + 1) and (b == 0 or done[p, c] >= b)
        r0, c0 = b * height, c * bw
        cap0, cap1 = caps[p]
        hh = min(height, m - r0, cap1 - c0 - 1 - r0)
        lanes = min(32, -(-(min(n, cap1 - r0 - 1) - c0) // width))
        edge = []
        for k in range(hh + 1):
            i = r0 + k
            if c == 0:
                v = (0, 0, 0) if i == 0 else (BIG, BIG, go + i * ic)
            elif b == 0 and k == 0:
                v = (BIG, go + c0 * d, BIG)
            else:
                v = tuple(int(x) for x in colbuf[p, b, k])
            edge.append((*v, int(ta[m + 1 - i if p else i]) if k else 0))
        prev, tok, diag = [], [], []
        for lane in range(32):
            j0 = c0 + lane * width + 1
            row = [(BIG, go + j * d, BIG) if b == 0 else
                   tuple(int(x) for x in rowbuf[p, j]) for j in range(j0, j0 + width)]
            prev.append([list(x) for x in row])
            tok.append([int(tb[n + 1 - j if p else j]) if j <= n else -1
                        for j in range(j0, j0 + width)])
            diag.append(edge[0][:3] if lane == 0 else tuple(prev[lane - 1][-1]))
        corner = tuple(prev[31][-1])
        right = [None] * hh
        last = [(BIG, BIG, BIG, 0)] * 32
        for k in range(hh + lanes - 1):
            before = list(last)
            for lane in range(32):
                left = edge[min(k + 1, hh)] if lane == 0 else before[lane - 1]
                r = k - lane
                if not (0 <= r < hh and lane < lanes):
                    continue
                (lm, lx, ly, a), i, j0 = left, r0 + 1 + r, c0 + lane * width + 1
                dg, xl, hl = diag[lane], lx, min(lm, ly)
                for q in range(width):
                    mp, xp, yp = prev[lane][q]
                    sub = cmatch if a == tok[lane][q] else cmismatch
                    mc = min(min(dg) + sub, BIG)
                    yc = min(min(min(mp, xp) + go, yp) + ic, BIG)
                    xc = min(xl + d, min(hl + go + d, BIG))
                    dg = (mp, xp, yp)
                    prev[lane][q] = [mc, xc, yc]
                    xl, hl = xc, min(mc, yc)
                diag[lane] = (lm, lx, ly)
                last[lane] = (*prev[lane][-1], a)
                if lane == 31:
                    right[r] = prev[lane][-1]
                for kk, cap in enumerate(caps[p]):
                    q = cap - i - j0
                    if 0 <= q < width and j0 + q <= n:
                        out[p, kk, :, i] = prev[lane][q]
        for lane in range(lanes):
            j0 = c0 + lane * width + 1
            rowbuf[p, j0 : j0 + width] = prev[lane]
        if lanes == 32:
            colbuf[p, b, 0] = corner
            colbuf[p, b, 1 : hh + 1] = right
        done[p, c] = b + 1
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("m,n", [(0, 0), (1, 0), (0, 3), (1, 1), (9, 4), (5, 23),
                                 (31, 30), (7, 97), (70, 65), (100, 33)])
def test_tile_schedule_emulation_equals_plain(m, n):
    """At tiny tiles (W = 1, H = 3: 32 x 3) the kernel's schedule, edge
    buffers and corner hand-off give ``_plain``'s captures at every row;
    the same in a shuffled order that still respects the producers."""
    rng = np.random.default_rng(11 * m + n)
    ta = np.concatenate([[0], rng.integers(0, 4, m + 2)]).astype(np.int32)
    tb = np.concatenate([[0], rng.integers(0, 4, n + 1)]).astype(np.int32)
    prm = fill_wave.uniform_scheme_params(BENCH_COST, ALPHA.gap_id)
    costs = (*prm, BENCH_GO)
    want = fill_wave.wave_frontiers(_t(ta), _t(tb), *costs, m, n)
    order = fill_wave.tile_order(m, n, 1, 3)
    assert torch.equal(_emulate_kernel(ta, tb, costs, m, n, 1, 3, order), want)
    # Any order in which a tile's producers come first: a random one.
    pending = [tuple(int(v) for v in t) for t in order]
    finished, shuffled = set(), []
    while pending:
        ready = [(code, c) for code, c in pending  # code = 2 b + p
                 if (code < 2 or (code - 2, c) in finished)
                 and (c == 0 or (code, c - 1) in finished)]
        t = ready[int(rng.integers(len(ready)))]
        pending.remove(t)
        finished.add(t)
        shuffled.append(t)
    got = _emulate_kernel(ta, tb, costs, m, n, 1, 3, np.array(shuffled).reshape(-1, 2))
    assert torch.equal(got, want)


# -- batch_final3_dual against TPU kernel #11 (npar = 2) ---------------------


def _dual_inputs():
    rng = np.random.default_rng(111)
    B, M, N = 4, 24, 40
    ta = rng.integers(1, 5, (2, B, M + 1)).astype(np.int32)
    tb = rng.integers(1, 5, (2, B, N + 1)).astype(np.int32)
    ta[..., 0] = 0
    tb[..., 0] = 0
    m2 = np.array([[24, 0, 7, 13], [1, 24, 19, 0]], np.int32)
    n2 = np.array([[40, 17, 0, 33], [40, 1, 29, 5]], np.int32)
    return ta, tb, m2, n2


def _per_set(ta, tb, cm, gid, go, m2, n2):
    return torch.stack([
        fill_batch.batch_final3(_t(ta[s]), _t(tb[s]), _t(cm), gid, go, m2[s], n2[s])
        for s in range(2)
    ])


def test_batch_final3_dual_matches_lanes_batch_final3_dual():
    """The uniform form: (cmatch, cmismatch, dcost, icost) = (0, 5, 3, 2),
    reached by the port through the scheme's costing matrix."""
    ta, tb, m2, n2 = _dual_inputs()
    cmatch, cmismatch, dcost, icost, go = 0, 5, 3, 2, 4
    gid = 5
    cm = np.full((6, 6), cmismatch, np.int32)
    np.fill_diagonal(cm, cmatch)
    cm[gid, :] = dcost
    cm[:, gid] = icost
    cm[gid, gid] = 0
    want = np.asarray(fill_lanes.lanes_batch_final3_dual(
        jnp.asarray(ta), jnp.asarray(tb), cmatch, cmismatch, dcost, icost, go,
        jnp.asarray(m2), jnp.asarray(n2), interpret=True,
    ))
    got = fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), gid, go, m2, n2)
    assert got.shape == (2, 4, 3)
    assert (got.numpy() == want).all()
    assert torch.equal(got, _per_set(ta, tb, cm, gid, go, m2, n2))


def test_batch_final3_dual_matches_lanes_general_final3_dual():
    """Any matrix: a random non-uniform 6 x 6 costing matrix, gap id 5."""
    ta, tb, m2, n2 = _dual_inputs()
    rng = np.random.default_rng(112)
    gid, go = 5, 3
    cm = rng.integers(0, 9, (6, 6)).astype(np.int32)
    cm[gid, gid] = 0
    want = np.asarray(fill_lanes.lanes_general_final3_dual(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), gid, go,
        jnp.asarray(m2), jnp.asarray(n2), interpret=True,
    ))
    got = fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), gid, go, m2, n2)
    assert (got.numpy() == want).all()
    assert torch.equal(got, _per_set(ta, tb, cm, gid, go, m2, n2))


def test_batch_final3_dual_checks_its_inputs():
    ta, tb, m2, n2 = _dual_inputs()
    cm = np.zeros((6, 6), np.int32)
    with pytest.raises(ValueError, match=r"\(2, B, M\+1\)"):
        fill_batch.batch_final3_dual(_t(ta[0]), _t(tb[0]), _t(cm), 5, 4, m2, n2)
    with pytest.raises(ValueError, match="m2 must have shape"):
        fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), 5, 4, m2[0], n2)
    with pytest.raises(ValueError, match="contiguous"):
        fill_batch.batch_final3_dual(
            _t(ta).transpose(1, 2).contiguous().transpose(1, 2), _t(tb),
            _t(cm), 5, 4, m2, n2,
        )
    with pytest.raises(ValueError, match="lie in"):
        fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), 5, 4, m2 + 1, n2)
