"""The port's long-pair path held against the JAX package, on the CPU.

``globalign_tpu_torch.ops.linear_tb`` (``align_blocked``, ``walk_block``)
and ``ops.fill_split.split_fill_cost`` on CPU tensors — the plain versions
of the ``gotoh_fill`` and ``walk_block`` kernels — fed the same seeded numpy
inputs as:

  * the JAX blocked traceback ``linear_tb.align_blocked(use_pallas=False)``
    and the full-matrix traceback: tapes, strings and cost identical
    (mirroring ``tests/test_linear_tb.py``);
  * the JAX device walk ``linear_tb._walk_block`` on the same move matrix:
    tapes, counts, exit column and level;
  * the JAX cost splits ``fill_pallas.split_fill_cost`` and
    ``fill_lanes.lanes_split_fill_cost`` in interpret mode.

Tolerance 0: every quantity is an integer or a string.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalign_tpu.ops import fill_lanes, fill_pallas
from globalign_tpu.ops import linear_tb as jax_ltb
from globalign_tpu_torch import resolve_scheme
from globalign_tpu_torch.ops import fill_cuda, fill_rows, fill_split, linear_tb
from globalign_tpu_torch.ops.traceback import alignment_cost, traceback_moves

DNA = "ACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"


def _scheme(kind):
    if kind == "dna":
        return resolve_scheme(DNA, DNA), DNA
    return resolve_scheme(PROTEIN, PROTEIN, scoring_mat_name="BLOSUM62"), PROTEIN


def _tokens(scheme, seq):
    tok = np.zeros(len(seq) + 1, np.int32)
    tok[1:] = scheme.alphabet.encode(seq)
    return tok


def _pairs(seed, letters, count, lo, hi):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        m, n = (int(x) for x in rng.integers(lo, hi, 2))
        yield (
            "".join(rng.choice(list(letters), m)),
            "".join(rng.choice(list(letters), n)),
        )


def _three_ways(scheme, s1, s2, block_rows):
    """(JAX blocked, port blocked, port full-matrix) tracebacks."""
    cm = np.ascontiguousarray(scheme.costing.values, np.int32)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    ta, tb = _tokens(scheme, s1), _tokens(scheme, s2)
    want = jax_ltb.align_blocked(
        ta, jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid), jnp.int32(go),
        s1, s2, block_rows=block_rows, use_pallas=False,
    )
    got = linear_tb.align_blocked(
        torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cm),
        gid, go, s1, s2, block_rows=block_rows,
    )
    res = fill_rows.row_fill(
        torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cm),
        gid, go,
    )
    full = traceback_moves(res.moves.numpy(), s1, s2, res.final3.numpy())
    return tuple(want), tuple(got), tuple(full)


@pytest.mark.parametrize("block_rows", [1, 7, 16, "m"])
def test_blocked_equals_jax_and_full_dna(block_rows):
    scheme, _ = _scheme("dna")
    seed = {1: 1, 7: 7, 16: 16, "m": 99}[block_rows]
    for s1, s2 in _pairs(seed, DNA, 4, 1, 90):
        k = len(s1) if block_rows == "m" else block_rows
        want, got, full = _three_ways(scheme, s1, s2, k)
        assert got == want == full, (k, s1, s2)
        assert alignment_cost(
            got[0], got[2], scheme.costing, scheme.gap_open_cost
        ) == got[3]


def test_blocked_equals_jax_and_full_blosum62():
    scheme, _ = _scheme("blosum62")
    for s1, s2 in _pairs(42, PROTEIN, 4, 1, 80):
        want, got, full = _three_ways(scheme, s1, s2, 13)
        assert got == want == full, (s1, s2)


@pytest.mark.parametrize("shape", [(0, 9), (9, 0), (0, 0), (1, 1), (1, 30)])
def test_blocked_boundary_shapes(shape):
    """Empty sides align without the blocked machinery; one-row pairs take
    it with one block."""
    scheme, _ = _scheme("dna")
    rng = np.random.default_rng(sum(shape))
    s1 = "".join(rng.choice(list(DNA), shape[0]))
    s2 = "".join(rng.choice(list(DNA), shape[1]))
    before = fill_cuda.batch_last_rows.launches
    want, got, full = _three_ways(scheme, s1, s2, 4)
    assert got == want == full
    assert fill_cuda.batch_last_rows.launches == before  # CPU: no kernel


def test_blocked_default_block_size():
    """K = max(512, min(m, 64 MiB // (n+1))) as in the JAX module."""
    assert linear_tb.DEFAULT_BLOCK_ROWS == jax_ltb.DEFAULT_BLOCK_ROWS == 512
    assert (
        linear_tb.DEFAULT_BLOCK_MOVES_BYTES
        == jax_ltb.DEFAULT_BLOCK_MOVES_BYTES
        == 64 * 1024 * 1024
    )
    assert len(linear_tb.block_bounds(10_000, 10_000)) - 1 == 2
    assert len(linear_tb.block_bounds(20_000, 20_000)) - 1 == 6
    assert len(linear_tb.block_bounds(9_000, 9_000)) - 1 == 2
    assert linear_tb.block_bounds(3000, 2500, 512) == [0, 512, 1024, 1536, 2048, 2560, 3000]
    assert linear_tb.block_bounds(300, 10) == [0, 300]
    assert (linear_tb.OP_DIAG, linear_tb.OP_LEFT, linear_tb.OP_UP) == (
        jax_ltb.OP_DIAG, jax_ltb.OP_LEFT, jax_ltb.OP_UP,
    )


@pytest.mark.parametrize("seed", range(3))
def test_walk_matches_jax_walk_block(seed):
    """The plain walk against ``_walk_block`` on the same move matrix: a
    block of rows of a full fill, any entry column and level."""
    rng = np.random.default_rng(seed)
    scheme, _ = _scheme("dna" if seed % 2 == 0 else "blosum62")
    letters = DNA if seed % 2 == 0 else PROTEIN
    cm = np.ascontiguousarray(scheme.costing.values, np.int32)
    for _ in range(4):
        m, n = (int(x) for x in rng.integers(1, 50, 2))
        s1 = "".join(rng.choice(list(letters), m))
        s2 = "".join(rng.choice(list(letters), n))
        moves = fill_rows.row_fill(
            torch.from_numpy(_tokens(scheme, s1)),
            torch.from_numpy(_tokens(scheme, s2)),
            torch.from_numpy(cm), scheme.alphabet.gap_id, scheme.gap_open_cost,
        ).moves.numpy()
        i0 = int(rng.integers(0, m))
        i1 = int(rng.integers(i0 + 1, m + 1))
        blk = np.ascontiguousarray(moves[i0 : i1 + 1])
        j0, level0 = int(rng.integers(0, n + 1)), int(rng.integers(0, 3))
        ops_w, count_w, j_w, level_w = (
            np.asarray(x) for x in jax_ltb._walk_block(
                jnp.asarray(blk), jnp.int32(j0), jnp.int32(level0)
            )
        )
        ops, count, j_exit, level_exit = linear_tb.walk_block(
            torch.from_numpy(blk)[None], [i1 - i0],
            torch.tensor([j0], dtype=torch.int32),
            torch.tensor([level0], dtype=torch.int32),
        )
        k = i1 - i0
        assert ops.shape == (1, k + n) and ops.dtype == torch.uint8
        assert int(count[0]) == int(count_w)
        assert (int(j_exit[0]), int(level_exit[0])) == (int(j_w), int(level_w))
        assert (ops[0].numpy() == ops_w[: k + n]).all()


def test_walk_batch_walks_each_pair_from_its_own_entry():
    """B = 3 walks in one call equal three single walks (the batch slice
    reuses the kernel one thread per pair)."""
    rng = np.random.default_rng(5)
    fields = rng.integers(0, 3, (3, 3, 12, 20))  # each level's predecessor
    moves = (fields[0] + 4 * fields[1] + 16 * fields[2]).astype(np.uint8)
    i_entry, j_entry, lv = [11, 4, 0], [19, 0, 7], [0, 2, 1]
    got = linear_tb.walk_block(
        torch.from_numpy(moves), i_entry,
        torch.tensor(j_entry, dtype=torch.int32),
        torch.tensor(lv, dtype=torch.int32),
    )
    for b in range(3):
        one = linear_tb.walk_block(
            torch.from_numpy(moves[b : b + 1]), [i_entry[b]],
            torch.tensor(j_entry[b : b + 1], dtype=torch.int32),
            torch.tensor(lv[b : b + 1], dtype=torch.int32),
        )
        for g, o in zip(got, one):
            assert torch.equal(g[b], o[0]), b
    assert int(got[1][2]) == 0 and int(got[2][2]) == 7  # row 0: no steps


def test_walk_checks_its_inputs():
    mv = torch.zeros((1, 5, 6), dtype=torch.uint8)
    j = torch.tensor([5], dtype=torch.int32)
    lv = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="lie in"):
        linear_tb.walk_block(mv, [5], j, lv)
    with pytest.raises(ValueError, match="int32"):
        linear_tb.walk_block(mv, [4], j.long(), lv)
    with pytest.raises(ValueError, match="uint8"):
        linear_tb.walk_block(mv.int(), [4], j, lv)
    meta = torch.zeros((1, 5, 6), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="is on"):
        linear_tb.walk_block(meta, [4], j, lv)


SPLIT_M = (0, 1, 2, 41)
SPLIT_N = (0, 1, 37)


@pytest.mark.parametrize("m", SPLIT_M)
@pytest.mark.parametrize("kind", ["dna", "blosum62"])
def test_split_cost_matches_jax_splits(kind, m):
    """``split_fill_cost`` against both JAX splits in interpret mode, on one
    buffer capacity with traced true lengths (one compile each), and
    against the direct final3 fill."""
    scheme, letters = _scheme(kind)
    cm = np.ascontiguousarray(scheme.costing.values, np.int32)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    uni = fill_pallas.uniform_scheme_params(cm, gid)
    assert (uni is None) == (kind == "blosum62")
    rng = np.random.default_rng(7 * m + len(kind))
    mcap, ncap = max(SPLIT_M), max(SPLIT_N)
    for n in SPLIT_N:
        s1 = "".join(rng.choice(list(letters), m))
        s2 = "".join(rng.choice(list(letters), n))
        ta = np.zeros(mcap + 1, np.int32)
        tb = np.zeros(ncap + 1, np.int32)
        ta[: m + 1] = _tokens(scheme, s1)
        tb[: n + 1] = _tokens(scheme, s2)
        ja, jb = jnp.asarray(ta), jnp.asarray(tb)
        want_stacked = int(fill_pallas.split_fill_cost(
            ja, jb, jnp.asarray(cm), jnp.int32(gid), jnp.int32(go), m, n,
            interpret=True,
        ))
        if uni is not None:
            want_lanes = int(fill_lanes.lanes_split_fill_cost(
                ja, jb, *(int(v) for v in uni), go, m, n, interpret=True
            ))
        else:
            want_lanes = int(fill_lanes.lanes_split_fill_cost(
                ja, jb, 0, 0, 0, 0, go, m, n, cost_mat=jnp.asarray(cm),
                gap_id=gid, interpret=True,
            ))
        ta_t = torch.from_numpy(ta[: m + 1].copy())
        tb_t = torch.from_numpy(tb[: n + 1].copy())
        got = fill_split.split_fill_cost(
            ta_t, tb_t, torch.from_numpy(cm), gid, go
        )
        assert got.dtype == torch.int32 and got.dim() == 0
        direct, _ = fill_cuda.batch_moves(
            ta_t[None], tb_t[None], torch.from_numpy(cm), gid, go, [m], [n],
            want_moves=False,
        )
        assert int(got) == want_stacked == want_lanes == int(direct.min()), (m, n)
