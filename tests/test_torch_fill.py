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
from globalign_tpu_torch.ops import fill_cuda, fill_rows, fill_scan


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


def test_plan_covers_every_column():
    for n in (0, 1, 31, 32, 500, 1000, 1024, 1025, 4096, 8000, 20000):
        threads, width = fill_cuda._plan(n)
        assert threads % 32 == 0 and 32 <= threads <= fill_cuda.MAX_THREADS
        assert threads * width >= n and width >= 1
