"""The port's fills held against the JAX package's, on the CPU.

``globalign_tpu_torch.ops.fill_rows.row_fill`` (the plain version of the
CUDA kernel) and ``ops.fill_cuda.batch_moves`` on CPU tensors, fed the same
seeded numpy inputs as:

  * the JAX row scan ``globalign_tpu.ops.fill_rows.row_fill`` — final3,
    moves, planes and last3 at every cell;
  * the three moves-emitting Pallas kernels the CUDA kernel replaces, run
    in interpret mode as ``tests/test_fill_lanes.py`` runs them — final3
    and the codes at real cells (i, j >= 1).

Tolerance 0: every quantity is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalign_tpu.ops import fill_lanes, fill_pallas
from globalign_tpu.ops import fill_rows as jax_rows
from globalign_tpu.ops import fill_scan as jax_scan
from globalign_tpu_torch.ops import fill_batch, fill_cuda, fill_rows, fill_scan


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _uniform_costing(A, cmatch, cmismatch, dcost, icost):
    """Costing matrix over 1-origin tokens 1..A with gap id A+1."""
    gid = A + 1
    cm = np.full((A + 2, A + 2), cmismatch, np.int32)
    np.fill_diagonal(cm, cmatch)
    cm[gid, :] = dcost
    cm[:, gid] = icost
    cm[gid, gid] = 0
    return cm, gid


def _ragged_batch(rng, B, m_pad, n_pad, toks):
    ta = rng.choice(toks, (B, m_pad + 1)).astype(np.int32)
    tb = rng.choice(toks, (B, n_pad + 1)).astype(np.int32)
    ta[:, 0] = 0
    tb[:, 0] = 0
    mt = rng.integers(1, m_pad + 1, B).astype(np.int32)
    nt = rng.integers(1, n_pad + 1, B).astype(np.int32)
    return ta, tb, mt, nt


def _jax_row_fill(ta, tb, cm, gid, go, mt=None, nt=None, **kw):
    return jax_rows.row_fill(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
        jnp.int32(go), None, None, mt, nt, **kw,
    )


def _assert_real_cells_match(got_moves, want_moves, mt, nt):
    for b in range(len(mt)):
        m, n = int(mt[b]), int(nt[b])
        assert (
            got_moves[b, 1 : m + 1, 1 : n + 1]
            == np.asarray(want_moves[b])[1 : m + 1, 1 : n + 1]
        ).all(), b


@pytest.mark.parametrize("seed", range(6))
def test_row_fill_matches_jax_row_scan_at_every_cell(seed):
    """Random (also negative-entry) matrices, gap id anywhere, true lengths
    below the buffers, zero lengths: all four outputs bit-identical."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        A = int(rng.integers(2, 9))
        gid = int(rng.integers(0, A))
        cm = rng.integers(-3, 10, (A, A)).astype(np.int32)
        go = int(rng.integers(0, 7))
        m, n = (int(x) for x in rng.integers(0, 25, 2))
        ta = rng.integers(0, A, m + 1).astype(np.int32)
        tb = rng.integers(0, A, n + 1).astype(np.int32)
        mt, nt = int(rng.integers(0, m + 1)), int(rng.integers(0, n + 1))
        want = _jax_row_fill(
            ta, tb, cm, gid, go, mt, nt, want_moves=True, want_planes=True
        )
        got = fill_rows.row_fill(
            _t(ta), _t(tb), _t(cm), gid, go, mt, nt,
            want_moves=True, want_planes=True,
        )
        for field in ("final3", "moves", "planes", "last3"):
            w = np.asarray(getattr(want, field))
            g = getattr(got, field).numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, field
            assert (g == w).all(), (seed, field, A, gid, m, n, mt, nt)


def test_row_fill_without_moves_or_planes():
    rng = np.random.default_rng(3)
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    ta = rng.integers(1, 5, 31).astype(np.int32)
    tb = rng.integers(1, 5, 17).astype(np.int32)
    res = fill_rows.row_fill(_t(ta), _t(tb), _t(cm), gid, 4, want_moves=False)
    assert res.moves is None and res.planes is None
    want = _jax_row_fill(ta, tb, cm, gid, 4, want_moves=False)
    assert (res.final3.numpy() == np.asarray(want.final3)).all()
    assert (res.last3.numpy() == np.asarray(want.last3)).all()
    with pytest.raises(ValueError, match="outside the buffers"):
        fill_rows.row_fill(_t(ta), _t(tb), _t(cm), gid, 4, 31, 1)


def test_default_boundary_matches_jax():
    rng = np.random.default_rng(5)
    cm = rng.integers(0, 9, (6, 6)).astype(np.int32)
    ta = rng.integers(0, 6, 12).astype(np.int32)
    tb = rng.integers(0, 6, 20).astype(np.int32)
    jr, jc = jax_scan.default_boundary(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), 2, jnp.int32(3)
    )
    tr, tc = fill_scan.default_boundary(_t(ta), _t(tb), _t(cm), 2, 3)
    assert fill_scan.BIG == int(jax_scan.BIG)
    assert (tr.numpy() == np.asarray(jr)).all()
    assert (tc.numpy() == np.asarray(jc)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_moves_cpu_matches_jax_row_scan(seed):
    """Ragged batch: final3 equal to the JAX batched row scan, codes equal
    at real cells, every other byte zero (the kernel's contract)."""
    rng = np.random.default_rng(seed)
    A = 7
    gid = int(rng.integers(0, A))
    cm = rng.integers(0, 9, (A, A)).astype(np.int32)
    toks = [k for k in range(A) if k != gid]
    ta, tb, mt, nt = _ragged_batch(rng, 4, 30, 41, toks)
    go = 4
    final3, moves = fill_cuda.batch_moves(
        _t(ta), _t(tb), _t(cm), gid, go, mt, nt
    )
    want = jax_rows.row_fill_batch(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
        jnp.int32(go), jnp.asarray(mt), jnp.asarray(nt), want_moves=True,
    )
    assert final3.dtype == torch.int32 and moves.dtype == torch.uint8
    assert moves.shape == (4, 31, 42)
    assert (final3.numpy() == np.asarray(want.final3)).all()
    moves = moves.numpy()
    _assert_real_cells_match(moves, want.moves, mt, nt)
    for b in range(4):
        real = np.zeros(moves.shape[1:], bool)
        real[1 : mt[b] + 1, 1 : nt[b] + 1] = True
        assert (moves[b][~real] == 0).all()

    cost_only, none = fill_cuda.batch_moves(
        _t(ta), _t(tb), _t(cm), gid, go, mt, nt, want_moves=False
    )
    assert none is None and torch.equal(cost_only, final3)


@pytest.mark.parametrize("B,m_pad,n_pad,w", [(3, 22, 30, 4), (1, 17, 60, 4)])
def test_batch_moves_matches_uniform_lane_kernel(B, m_pad, n_pad, w):
    """TPU kernel #1: the lane kernel's uniform moves mode
    (``lanes_batch_moves`` + ``lanes_moves_to_row``)."""
    rng = np.random.default_rng(13 + B)
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    go = 4
    ta, tb, mt, nt = _ragged_batch(rng, B, m_pad, n_pad, [1, 2, 3, 4])
    f3, mv = fill_lanes.lanes_batch_moves(
        jnp.asarray(ta), jnp.asarray(tb), 0, 5, 3, 2, go,
        jnp.asarray(mt), jnp.asarray(nt), w=w, interpret=True,
    )
    want_moves = fill_lanes.lanes_moves_to_row(np.asarray(mv), B, n_pad, w, m_pad)
    final3, moves = fill_cuda.batch_moves(_t(ta), _t(tb), _t(cm), gid, go, mt, nt)
    assert (final3.numpy() == np.asarray(f3)).all()
    _assert_real_cells_match(moves.numpy(), want_moves, mt, nt)


def test_batch_moves_matches_general_lane_kernel():
    """TPU kernel #2: the lane kernel's general moves mode
    (``lanes_general_moves``, select-chain substitution) on a random
    asymmetric matrix with the gap id inside the alphabet."""
    rng = np.random.default_rng(23)
    A, gid, go = 6, 2, 3
    cm = rng.integers(0, 9, (A, A)).astype(np.int32)
    cm[gid, gid] = 0
    toks = [k for k in range(A) if k != gid]
    B, m_pad, n_pad = 2, 21, 27
    ta, tb, mt, nt = _ragged_batch(rng, B, m_pad, n_pad, toks)
    f3, mv = fill_lanes.lanes_general_moves(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), gid, go,
        jnp.asarray(mt), jnp.asarray(nt), w=4, interpret=True,
    )
    want_moves = fill_lanes.lanes_moves_to_row(np.asarray(mv), B, n_pad, 4, m_pad)
    final3, moves = fill_cuda.batch_moves(_t(ta), _t(tb), _t(cm), gid, go, mt, nt)
    assert (final3.numpy() == np.asarray(f3)).all()
    _assert_real_cells_match(moves.numpy(), want_moves, mt, nt)


def test_batch_moves_matches_stacked_moves_kernel():
    """TPU kernel #3: the stacked moves kernel
    (``stacked_fill_with_moves``), the path for alphabets the lane kernel
    turns down — here a 40-token simple-costing alphabet."""
    rng = np.random.default_rng(91)
    A = 40
    gid = A - 1
    cm = np.full((A, A), 5, np.int32)
    np.fill_diagonal(cm, 0)
    cm[gid, :] = 3
    cm[:, gid] = 2
    cm[gid, gid] = 0
    go = 4
    B, m_pad, n_pad = 3, 24, 40
    ta, tb, mt, nt = _ragged_batch(rng, B, m_pad, n_pad, list(range(A - 1)))
    last, mv = fill_pallas.stacked_fill_with_moves(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
        jnp.int32(go), jnp.asarray(mt), jnp.asarray(nt), interpret=True,
    )
    last, mv = np.asarray(last), np.asarray(mv)
    final3, moves = fill_cuda.batch_moves(_t(ta), _t(tb), _t(cm), gid, go, mt, nt)
    for b in range(B):
        assert (final3[b].numpy() == last[b][:, nt[b]]).all(), b
    _assert_real_cells_match(moves.numpy(), mv, mt, nt)


def test_batch_moves_checks_its_inputs():
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    ta = torch.ones((1, 9), dtype=torch.int32)
    tb = torch.ones((1, 7), dtype=torch.int32)
    cmt = _t(cm)
    ok = fill_cuda.batch_moves(ta, tb, cmt, gid, 4, [8], [6])
    assert ok[0].shape == (1, 3) and ok[1].shape == (1, 9, 7)
    with pytest.raises(TypeError, match="int32"):
        fill_cuda.batch_moves(ta.long(), tb, cmt, gid, 4, [8], [6])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.ones((1, 18), dtype=torch.int32)
        fill_cuda.batch_moves(wide[:, ::2], tb, cmt, gid, 4, [8], [6])
    with pytest.raises(ValueError, match="lie in"):
        fill_cuda.batch_moves(ta, tb, cmt, gid, 4, [9], [6])
    with pytest.raises(ValueError, match="shape"):
        fill_cuda.batch_moves(ta, tb, cmt, gid, 4, [8, 8], [6])
    with pytest.raises(ValueError, match="square"):
        fill_cuda.batch_moves(ta, tb, cmt[:, :3].contiguous(), gid, 4, [8], [6])
    with pytest.raises(ValueError, match="gap_id"):
        fill_cuda.batch_moves(ta, tb, cmt, 6, 4, [8], [6])


def test_batch_moves_has_no_route_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a GPU raises; nothing falls back."""
    ta = torch.ones((1, 9), dtype=torch.int32, device="meta")
    tb = torch.ones((1, 7), dtype=torch.int32, device="meta")
    cm = torch.zeros((5, 5), dtype=torch.int32, device="meta")
    before = fill_cuda.batch_moves.launches
    with pytest.raises(ValueError, match="no gotoh_fill route"):
        fill_cuda.batch_moves(ta, tb, cm, 4, 4, [8], [6])
    assert fill_cuda.batch_moves.launches == before


SMS = 132  # the H100 SXM's SMs
REGISTERS = 65_536  # 32-bit registers an SM
PLAN_BATCHES = (1, 2, 7, 21, 64, 131, 132, 133, 500, 1024)


def _plan_widths():
    """Every n the plan tests visit: all of 1..300, each band and pass
    width of every instance +-1, and a geometric walk to 50 000."""
    ns = set(range(1, 301)) | {50_000}
    for w in fill_cuda.WIDTHS:
        for warps in range(1, fill_cuda.MAX_WARPS + 1):
            for bands in range(1, fill_cuda.MAX_BANDS + 1):
                edge = bands * warps * 32 * w
                ns |= {edge - 1, edge, edge + 1}
    x = 300.0
    while x < 50_000:
        ns.add(int(x))
        x *= 1.07
    return sorted(n for n in ns if 1 <= n <= 50_000)


def _kernel_constants():
    """The launch limits and instances that csrc/gotoh_fill.cu builds."""
    import re

    from globalign_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / "gotoh_fill.cu").read_text()
    consts = {
        name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        for name in ("MAX_WARPS", "MAX_BANDS", "RING", "CH")
    }
    pick = src[src.index("Kernel pick_width"):]
    pick = pick[: pick.index("\n}\n")]
    consts["widths"] = tuple(int(w) for w in re.findall(r"case (\d+):", pick))
    return consts


def test_plan_limits_match_the_kernel():
    """The plan's constants are the kernel's: warps a block, bands a
    cluster, the W instances (codes stop at W = 16)."""
    k = _kernel_constants()
    assert k["MAX_WARPS"] == fill_cuda.MAX_WARPS
    assert k["MAX_BANDS"] == fill_cuda.MAX_BANDS
    assert k["widths"] == fill_cuda.WIDTHS
    assert set(fill_cuda.MOVES_WIDTHS) < set(fill_cuda.WIDTHS)


@pytest.mark.parametrize("want_moves", [False, True])
@pytest.mark.parametrize("batch", PLAN_BATCHES)
def test_plan_covers_every_column(batch, want_moves):
    """Over n = 1..50 000: every column lies in exactly one strip (pass,
    band, warp, lane) of the launch, every band of the first pass holds a
    column, and W is a built instance."""
    widths = fill_cuda.MOVES_WIDTHS if want_moves else fill_cuda.WIDTHS
    for n in _plan_widths():
        lp = fill_cuda.plan(batch, n, want_moves, SMS)
        assert lp.width in widths
        assert 1 <= lp.warps <= fill_cuda.MAX_WARPS
        assert 1 <= lp.bands <= fill_cuda.MAX_BANDS
        per_pass = lp.bands * lp.band_columns
        assert (lp.passes - 1) * per_pass < n <= lp.passes * per_pass
        assert (lp.bands - 1) * lp.band_columns < min(n, per_pass)
        # the kernel's map: column j -> pass, band, warp, lane, slot
        j = np.arange(n, dtype=np.int64)
        q, r = np.divmod(j, per_pass)
        g, s = np.divmod(r, 32 * lp.width)
        band, warp = np.divmod(g, lp.warps)
        lane, slot = np.divmod(s, lp.width)
        assert band.max() < lp.bands and q.max() < lp.passes
        key = (((q * lp.bands + band) * lp.warps + warp) * 32 + lane) * lp.width + slot
        assert np.array_equal(np.sort(key), j)


@pytest.mark.parametrize("want_moves", [False, True])
@pytest.mark.parametrize("batch", PLAN_BATCHES)
def test_plan_fits_the_card(batch, want_moves):
    """The block's shared memory (rings, flags, staged codes) leaves room
    for a 60-letter cost table; its threads can hold 255 registers each;
    a batch that fills the card gets one block a pair where one block of
    the widest instance holds the pair, and a small batch spreads a pair
    over more SMs."""
    widest = (fill_cuda.MOVES_WIDTHS if want_moves else fill_cuda.WIDTHS)[-1]
    k = _kernel_constants()
    barriers = 2 * k["MAX_WARPS"] * (k["RING"] // k["CH"] * 8 + 4)
    for n in _plan_widths():
        lp = fill_cuda.plan(batch, n, want_moves, SMS)
        # a warp's edge ring of int4s and, with codes, its 32 staged rows of
        # 32 W bytes and at most 8 of bank padding; the launcher refuses
        # whatever the card itself cannot place
        smem = lp.warps * k["RING"] * 16 + barriers
        if want_moves:
            smem += lp.warps * 32 * (32 * lp.width + 8)
        assert smem + 4 * 60 * 60 <= fill_batch.SMEM_OPTIN
        assert lp.warps * 32 * 255 <= REGISTERS
        if batch >= SMS and n <= fill_cuda.MAX_WARPS * 32 * widest:
            assert lp.bands == 1
        if batch < SMS and n > 32 * lp.width:  # a chain of 2+ warps
            assert lp.bands > 1


def test_plan_main_shapes():
    """The launches of the main paths' shapes (PERF.md section 6)."""
    P = fill_cuda.FillPlan
    assert fill_cuda.plan(1, 8000, True, SMS) == P(4, 8, 8, 1)
    assert fill_cuda.plan(1, 8000, False, SMS) == P(4, 8, 8, 1)
    assert fill_cuda.plan(1, 20_000, True, SMS) == P(16, 5, 8, 1)
    assert fill_cuda.plan(1, 50_000, False, SMS) == P(32, 7, 7, 1)
    assert fill_cuda.plan(21, 1024, True, SMS) == P(4, 2, 4, 1)
    assert fill_cuda.plan(1024, 1024, False, SMS) == P(4, 8, 1, 1)
    assert fill_cuda.plan(1, 100_000, False, SMS).passes == 2


# -- boundary injection and last rows (the blocked traceback's fills) -----


@pytest.mark.parametrize("seed", range(4))
def test_row_fill_injected_boundary_matches_jax_at_every_cell(seed):
    """``row_fill(row0=, col0=)`` against the JAX row scan with the same
    overrides: random boundaries (negative entries and BIG included), true
    lengths below the buffers, zero lengths."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        A = int(rng.integers(2, 9))
        gid = int(rng.integers(0, A))
        cm = rng.integers(-3, 10, (A, A)).astype(np.int32)
        go = int(rng.integers(0, 7))
        m, n = (int(x) for x in rng.integers(0, 25, 2))
        ta = rng.integers(0, A, m + 1).astype(np.int32)
        tb = rng.integers(0, A, n + 1).astype(np.int32)
        mt, nt = int(rng.integers(0, m + 1)), int(rng.integers(0, n + 1))
        row0 = rng.integers(-5, 60, (3, n + 1)).astype(np.int32)
        row0[rng.random((3, n + 1)) < 0.2] = fill_scan.BIG
        col0 = rng.integers(-5, 60, (3, m + 1)).astype(np.int32)
        want = jax_rows.row_fill(
            jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
            jnp.int32(go), jnp.asarray(row0), jnp.asarray(col0), mt, nt,
            want_moves=True, want_planes=True,
        )
        got = fill_rows.row_fill(
            _t(ta), _t(tb), _t(cm), gid, go, mt, nt, row0=_t(row0),
            col0=_t(col0), want_moves=True, want_planes=True,
        )
        for field in ("final3", "moves", "planes", "last3"):
            w = np.asarray(getattr(want, field))
            g = getattr(got, field).numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, field
            assert (g == w).all(), (seed, field, A, gid, m, n, mt, nt)


def _uniform_pair(rng, m, n, go=4):
    """A DNA-like pair under ``_uniform_costing(4, 0, 5, 3, 2)``, its full
    plain fill (planes, moves) and the default column-0 boundary."""
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    ta = np.zeros(m + 1, np.int32)
    ta[1:] = rng.integers(1, 5, m)
    tb = np.zeros(n + 1, np.int32)
    tb[1:] = rng.integers(1, 5, n)
    full = fill_rows.row_fill(
        _t(ta), _t(tb), _t(cm), gid, go, want_moves=True, want_planes=True
    )
    _, col0 = fill_scan.default_boundary(_t(ta), _t(tb), _t(cm), gid, go)
    return cm, gid, ta, tb, full.planes.numpy(), full.moves.numpy(), col0.numpy()


def _block(ta, planes, col0, go, i0, i1):
    """Rows i0+1..i1 as a block: its tokens, checkpoint row i0 and the
    column-0 Iy seed (gap_open for the top block)."""
    ta_blk = ta[i0 : i1 + 1].copy()
    ta_blk[0] = 0
    return ta_blk, planes[:, i0, :].copy(), go if i0 == 0 else int(col0[2, i0])


def test_injected_block_reproduces_the_rows_of_the_full_fill():
    """The plain injected fills of a block equal the full fill's rows:
    ``batch_last_rows`` row i1 at every column, ``batch_moves`` codes at
    every real cell and final3 — for blocks of one row up to all rows."""
    rng = np.random.default_rng(41)
    go = 4
    cm, gid, ta, tb, planes, moves, col0 = _uniform_pair(rng, 30, 25, go)
    n = 25
    for i0, i1 in [(0, 1), (0, 13), (11, 30), (29, 30), (0, 30)]:
        ta_blk, row0, c0 = _block(ta, planes, col0, go, i0, i1)
        k = i1 - i0
        inj = dict(row0=_t(row0)[None], col0y_top=torch.tensor([c0], dtype=torch.int32))
        last = fill_cuda.batch_last_rows(
            _t(ta_blk)[None], _t(tb)[None], _t(cm), gid, go, [k], [n], **inj
        )
        assert (last[0].numpy() == planes[:, i1, :]).all(), (i0, i1)
        final3, mv = fill_cuda.batch_moves(
            _t(ta_blk)[None], _t(tb)[None], _t(cm), gid, go, [k], [n], **inj
        )
        assert (final3[0].numpy() == planes[:, i1, n]).all()
        assert (mv[0, 1:, 1:].numpy() == moves[i0 + 1 : i1 + 1, 1:]).all()
        assert (mv[0, 0].numpy() == 0).all() and (mv[0, :, 0].numpy() == 0).all()


def test_batch_last_rows_ragged_and_boundary_rows():
    """A ragged batch: last rows equal the row scan's ``last3`` per pair up
    to n_true, BIG past it; a zero-row pair gives its row 0 (corner
    (0, 0, 0)), a zero-column pair its column-0 cell."""
    rng = np.random.default_rng(43)
    A = 7
    gid = 3
    cm = rng.integers(0, 9, (A, A)).astype(np.int32)
    toks = [k for k in range(A) if k != gid]
    ta, tb, _, _ = _ragged_batch(rng, 4, 20, 30, toks)
    mt, nt = [20, 0, 7, 12], [17, 30, 0, 30]
    last = fill_cuda.batch_last_rows(_t(ta), _t(tb), _t(cm), gid, 5, mt, nt)
    assert last.shape == (4, 3, 31) and last.dtype == torch.int32
    for b in range(4):
        m, n = mt[b], nt[b]
        want = fill_rows.row_fill(
            _t(ta[b, : m + 1]), _t(tb[b, : n + 1]), _t(cm), gid, 5,
            want_moves=False,
        ).last3
        assert torch.equal(last[b, :, : n + 1], want), b
        assert (last[b, :, n + 1 :] == fill_scan.BIG).all(), b
    assert last[1, :, 0].tolist() == [0, 0, 0]
    assert last[2, :2, 0].tolist() == [fill_scan.BIG, fill_scan.BIG]


@pytest.mark.parametrize(
    "kernel",
    ["row_fill_last_rows", "stacked_fill_with_moves", "lanes_batch_last_rows",
     "lanes_batch_moves"],
)
def test_injected_fills_match_the_pallas_kernels(kernel):
    """TPU kernels #6, #3, #4 (last rows) and #1 with a checkpoint row
    injected, in interpret mode: last rows (every column they define) and
    codes at real cells (lane codes unskewed with ``lanes_moves_to_row``)
    equal the port's plain injected fills."""
    rng = np.random.default_rng(17)
    go, n, w = 4, 25, 4
    cm, gid, ta, tb, planes, _, col0 = _uniform_pair(rng, 30, n, go)
    for i0, i1 in [(0, 13), (11, 30)]:
        ta_blk, row0, c0 = _block(ta, planes, col0, go, i0, i1)
        k = i1 - i0
        inj = dict(row0=_t(row0)[None], col0y_top=torch.tensor([c0], dtype=torch.int32))
        last = fill_cuda.batch_last_rows(
            _t(ta_blk)[None], _t(tb)[None], _t(cm), gid, go, [k], [n], **inj
        )[0].numpy()
        final3, mv = fill_cuda.batch_moves(
            _t(ta_blk)[None], _t(tb)[None], _t(cm), gid, go, [k], [n], **inj
        )
        mv = mv[0].numpy()
        args = (jnp.asarray(ta_blk), jnp.asarray(tb))
        if kernel == "row_fill_last_rows":
            steps = np.r_[0, cm[ta_blk[1:], gid]]
            col0y = (c0 + np.cumsum(steps)).astype(np.int32)
            got = np.asarray(fill_pallas.row_fill_last_rows(
                *args, jnp.asarray(cm), jnp.int32(gid), jnp.int32(go),
                row0=jnp.asarray(row0), col0y=jnp.asarray(col0y),
                interpret=True,
            ))
            assert (got[:, : n + 1] == last).all(), (i0, i1)
        elif kernel == "stacked_fill_with_moves":
            got_last, got_mv = fill_pallas.stacked_fill_with_moves(
                args[0][None], args[1][None], jnp.asarray(cm), jnp.int32(gid),
                jnp.int32(go), jnp.asarray([k]), jnp.asarray([n]),
                jnp.asarray(row0)[None], jnp.asarray([c0]), interpret=True,
            )
            assert (np.asarray(got_last)[0][:, : n + 1] == last).all()
            _assert_real_cells_match(mv[None], np.asarray(got_mv), [k], [n])
        else:
            lane_args = (
                args[0][None], args[1][None], 0, 5, 3, 2, go,
                jnp.asarray([k], np.int32), jnp.asarray([n], np.int32),
                jnp.asarray(row0)[None], jnp.asarray([c0], np.int32),
            )
            if kernel == "lanes_batch_last_rows":
                got = np.asarray(fill_lanes.lanes_batch_last_rows(
                    *lane_args, w=w, interpret=True
                ))
                assert (got[0][:, :n] == last[:, 1:]).all(), (i0, i1)
            else:
                f3, got_mv = fill_lanes.lanes_batch_moves(
                    *lane_args, w=w, interpret=True
                )
                assert (np.asarray(f3) == final3.numpy()).all()
                rows = fill_lanes.lanes_moves_to_row(np.asarray(got_mv), 1, n, w, k)
                _assert_real_cells_match(mv[None], rows, [k], [n])


def test_batch_last_rows_matches_stacked_cost_kernel():
    """TPU kernel #5: ``stacked_fill_last_rows`` (default boundary, ragged
    batch) in interpret mode — every column up to n_true, column 0 too."""
    rng = np.random.default_rng(47)
    A, gid, go = 6, 5, 3
    cm = rng.integers(0, 9, (A, A)).astype(np.int32)
    cm[gid, gid] = 0
    ta, tb, mt, nt = _ragged_batch(rng, 3, 24, 33, list(range(5)))
    got = np.asarray(fill_pallas.stacked_fill_last_rows(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
        jnp.int32(go), jnp.asarray(mt), jnp.asarray(nt), interpret=True,
    ))
    last = fill_cuda.batch_last_rows(_t(ta), _t(tb), _t(cm), gid, go, mt, nt)
    for b in range(3):
        assert (got[b][:, : nt[b] + 1] == last[b, :, : nt[b] + 1].numpy()).all(), b


def test_injection_arguments_are_checked():
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    ta = torch.ones((2, 9), dtype=torch.int32)
    tb = torch.ones((2, 7), dtype=torch.int32)
    row0 = torch.zeros((2, 3, 7), dtype=torch.int32)
    c0 = torch.zeros((2,), dtype=torch.int32)
    args = (ta, tb, _t(cm), gid, 4, [8, 3], [6, 2])
    assert fill_cuda.batch_last_rows(*args, row0, c0).shape == (2, 3, 7)
    with pytest.raises(ValueError, match="row0 must be"):
        fill_cuda.batch_last_rows(*args, row0[:, :, :6].contiguous(), c0)
    with pytest.raises(ValueError, match="col0y_top must be"):
        fill_cuda.batch_moves(*args, row0=row0, col0y_top=c0[:1])
    with pytest.raises(TypeError, match="int32"):
        fill_cuda.batch_moves(*args, row0=row0.long())
    with pytest.raises(ValueError, match="contiguous"):
        fill_cuda.batch_last_rows(*args, None, torch.zeros((4,), dtype=torch.int32)[::2])


def test_every_kernel_source_is_bound():
    """Each ``csrc/*.cu`` has its C entry points declared for ``ctypes``."""
    from globalign_tpu_torch.utils import cuda_build

    stems = {src.stem for src in cuda_build.sources()}
    assert stems == set(cuda_build.SIGNATURES) == {
        "gotoh_fill", "gotoh_batch", "gotoh_batch_moves", "gotoh_tile",
        "walk_block", "wave_split", "tokenize", "render",
    }
    for stem in stems:
        text = (cuda_build.CSRC_DIR / f"{stem}.cu").read_text()
        for name in cuda_build.SIGNATURES[stem]:
            assert f" {name}(" in text, name
    assert len({cuda_build.library_path(s) for s in cuda_build.sources()}) == 8
