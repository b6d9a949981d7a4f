"""The port's parallel layer on the CPU, against the JAX package's.

In this process: the row scan's strip modes (``col0_full``, ``want_edge``,
``want_fin_row``) against the JAX ``row_fill_impl``; the strip mode's plain
version (``fill_cuda.strip_fill_block`` on CPU tensors) against TPU kernel
#10, ``fill_pallas.strip_fill_block``, in interpret mode; a world of one
(one gloo rank) against no mesh.

On spawned gloo ranks (``tests/torch_dist_harness.py``; the ranks import
no JAX): ``sharded_pair_cost``, ``sharded_block_last_rows`` and
``align_blocked(mesh=)`` on 4 and 3 ranks against the JAX
``parallel/seqpar`` on the conftest's 8-device CPU mesh (the cases of
``tests/test_seqpar.py``: block_rows 1/3/16/64, BLOSUM62, a gap run that
spans strips, n < D), and ``align_pairs(mesh=)`` on 10 and 13 pairs (padded
to the mesh, pad dropped) against the JAX ``align_pairs(mesh=)``.  Every
rank must return the same answer.  Tolerance 0: all integers and strings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from globalign_tpu import align_pairs as jax_align_pairs
from globalign_tpu.config import resolve_scheme as jax_resolve_scheme
from globalign_tpu.ops import fill_pallas
from globalign_tpu.ops.fill_rows import row_fill as jax_row_fill
from globalign_tpu.ops.fill_rows import row_fill_impl
from globalign_tpu.ops.fill_scan import default_boundary as jax_default_boundary
from globalign_tpu.ops.linear_tb import align_blocked as jax_align_blocked
from globalign_tpu.parallel import seqpar as jax_seqpar
from globalign_tpu_torch import align_pairs, resolve_scheme
from globalign_tpu_torch.ops import fill_cuda, linear_tb
from globalign_tpu_torch.ops.fill_rows import row_fill
from globalign_tpu_torch.ops.fill_scan import BIG
from globalign_tpu_torch.parallel import make_pair_mesh, multihost, seqpar
from tests.torch_dist_harness import run_ranks

DNA = "ACGT"
PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
SCHEMES = {
    "dna": (DNA, {}),
    "blosum62": (PROTEIN, {"scoring_mat_name": "BLOSUM62"}),
    # odd max score: dcost != icost
    "odd_asym": (DNA, {"match_score": 3, "mismatch_score": -2,
                       "gap_open_score": -5, "gap_extension_score": -1}),
}


def _scheme(name):
    letters, kw = SCHEMES[name]
    return resolve_scheme(letters, letters, **kw), letters


def _cost(scheme):
    return np.ascontiguousarray(scheme.costing.values, dtype=np.int32)


def _tokens(scheme, seq):
    return np.asarray([0, *scheme.alphabet.encode(seq)], np.int32)


def _seq(rng, letters, k):
    return "".join(rng.choice(list(letters), k))


# -- the strip modes, in this process --------------------------------------


@pytest.mark.parametrize("name", list(SCHEMES))
@pytest.mark.parametrize("seed", [0, 1])
def test_row_fill_strip_modes_match_jax(name, seed):
    """``col0_full`` / ``want_edge`` / ``want_fin_row`` against the JAX row
    scan: final3, codes, last row, edge and the row at m_true, with BIG
    cells in the boundaries and m_true short of the buffer."""
    scheme, letters = _scheme(name)
    rng = np.random.default_rng(seed)
    cm, gid, go = _cost(scheme), scheme.alphabet.gap_id, scheme.gap_open_cost
    for m, n in ((17, 23), (29, 6)):  # two shapes: one compile each
        ta = _tokens(scheme, _seq(rng, letters, m))
        tb = _tokens(scheme, _seq(rng, letters, n))
        row0 = rng.integers(0, 60, (3, n + 1)).astype(np.int32)
        col0 = rng.integers(0, 60, (3, m + 1)).astype(np.int32)
        row0[0, rng.integers(0, n + 1)] = BIG
        col0[1, rng.integers(0, m + 1)] = BIG
        m_true = int(rng.integers(0, m + 1))
        edge_col = int(rng.integers(0, n + 1))
        want = jax_row_fill(
            jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), gid, go,
            jnp.asarray(row0), jnp.asarray(col0), m_true, n,
            want_moves=True, col0_full=True, want_edge=True,
            edge_col=edge_col, want_fin_row=True,
        )
        got = row_fill(
            torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cm),
            gid, go, m_true, n, row0=torch.from_numpy(row0),
            col0=torch.from_numpy(col0), col0_full=True, want_edge=True,
            edge_col=edge_col, want_fin_row=True,
        )
        for field in ("final3", "moves", "last3", "edge", "fin_row"):
            assert (np.asarray(getattr(want, field))
                    == getattr(got, field).numpy()).all(), (field, m, n)


def test_row_fill_col0_full_needs_col0():
    scheme, _ = _scheme("dna")
    tok = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="col0_full"):
        row_fill(tok, tok, torch.from_numpy(_cost(scheme)), 4, 3,
                 col0_full=True)


def _strip_inputs(rng, scheme, letters, rb, width):
    """A block of ``rb`` rows under a real checkpoint row, cut into a left
    strip (at the matrix edge) of 37 columns and the strip of ``width``
    columns to its right, whose col0 is the left strip's edge."""
    cm = torch.from_numpy(_cost(scheme))
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    i0, left = 5, 37
    ta_full = torch.from_numpy(_tokens(scheme, _seq(rng, letters, i0 + rb)))
    tb_full = torch.from_numpy(_tokens(scheme, _seq(rng, letters, left + width)))
    top = row_fill(ta_full[: i0 + 1], tb_full, cm, gid, go,
                   want_moves=False).last3
    steps = cm[ta_full[i0:], gid].clone()
    steps[0] = 0
    col0_edge = torch.stack([
        torch.full((rb + 1,), BIG, dtype=torch.int32),
        torch.full((rb + 1,), BIG, dtype=torch.int32),
        int(top[2, 0]) + torch.cumsum(steps, 0, dtype=torch.int32),
    ])
    ta = ta_full[i0:].clone()
    ta[0] = 0
    _, edge = fill_cuda.strip_fill_block(
        ta[None], tb_full[None, : left + 1].contiguous(), cm, gid, go,
        top[None, :, : left + 1].contiguous(), col0_edge[None], [rb],
    )
    tb = torch.cat([torch.zeros(1, dtype=torch.int32), tb_full[left + 1 :]])
    return ta, tb, cm, gid, go, top[:, left:].contiguous(), edge[0]


@pytest.mark.parametrize("rb,width", [(13, 300), (3, 1), (1, 31), (16, 129)])
def test_plain_strip_block_matches_pallas_interpret(rb, width):
    """The strip mode's plain version against TPU kernel #10
    (``fill_pallas.strip_fill_block``, interpret mode), its col0 a real
    neighbour's edge: fin at every column, the edge at rows 1..m_true, and
    edge row 0 = row0 at the strip's last column."""
    scheme, letters = _scheme("dna")
    rng = np.random.default_rng(rb * 1000 + width)
    ta, tb, cm, gid, go, row0, col0 = _strip_inputs(
        rng, scheme, letters, rb, width
    )
    for m_true in sorted({rb, max(0, rb - 2)}):
        fin, edge = fill_cuda.strip_fill_block(
            ta[None], tb[None], cm, gid, go, row0[None], col0[None], [m_true]
        )
        _, want_fin, want_edge = fill_pallas.strip_fill_block(
            jnp.asarray(ta.numpy()), jnp.asarray(tb.numpy()),
            jnp.asarray(cm.numpy()), gid, go, jnp.asarray(row0.numpy()),
            jnp.asarray(col0.numpy()), m_true, interpret=True,
        )
        want_fin, want_edge = np.asarray(want_fin), np.asarray(want_edge)
        assert (fin[0].numpy() == want_fin[:, : width + 1]).all()
        assert (edge[0, :, 1 : m_true + 1].numpy()
                == want_edge[:, :m_true]).all()
        assert (edge[0, :, 0] == row0[:, width]).all()
        assert (edge[0, :, m_true + 1 :] == BIG).all()


@pytest.mark.parametrize("name", list(SCHEMES))
def test_strip_block_modes_of_the_plain_version(name):
    """The wrapper's contract on the CPU: fin is row m_true (row0 itself at
    m_true = 0); a strip of no columns is its left edge; a batch of blocks
    of ragged row counts equals its blocks one by one."""
    scheme, letters = _scheme(name)
    rng = np.random.default_rng(7)
    ta, tb, cm, gid, go, row0, col0 = _strip_inputs(rng, scheme, letters, 9, 40)
    fin, edge = fill_cuda.strip_fill_block(
        ta[None], tb[None], cm, gid, go, row0[None], col0[None], [0]
    )
    assert torch.equal(fin[0], row0) and (edge[0, :, 1:] == BIG).all()
    fin, edge = fill_cuda.strip_fill_block(
        ta[None], tb[None, :1].contiguous(), cm, gid, go,
        row0[None, :, :1].contiguous(), col0[None], [9],
    )
    assert torch.equal(fin[0, :, 0], col0[:, 9])
    assert torch.equal(edge[0, :, 1:], col0[:, 1:])
    both_fin, both_edge = fill_cuda.strip_fill_block(
        torch.stack([ta, ta]), torch.stack([tb, tb]), cm, gid, go,
        torch.stack([row0, row0]), torch.stack([col0, col0]), [9, 4],
    )
    for b, m in enumerate((9, 4)):
        one_fin, one_edge = fill_cuda.strip_fill_block(
            ta[None], tb[None], cm, gid, go, row0[None], col0[None], [m],
        )
        assert torch.equal(both_fin[b], one_fin[0])
        assert torch.equal(both_edge[b], one_edge[0])


def test_strip_block_rejects_what_the_kernel_cannot_take():
    scheme, letters = _scheme("dna")
    rng = np.random.default_rng(3)
    ta, tb, cm, gid, go, row0, col0 = _strip_inputs(rng, scheme, letters, 4, 9)
    with pytest.raises(ValueError, match="col0 must be"):
        fill_cuda.strip_fill_block(ta[None], tb[None], cm, gid, go,
                                   row0[None], col0[None, :, :3], [4])
    with pytest.raises(ValueError, match="needs row0 and col0"):
        fill_cuda.strip_fill_block(ta[None], tb[None], cm, gid, go, None,
                                   col0[None], [4])
    with pytest.raises(TypeError, match="int32"):
        fill_cuda.strip_fill_block(ta[None], tb[None], cm, gid, go,
                                   row0[None], col0[None].long(), [4])
    meta = [x.to("meta") for x in (ta[None], tb[None], cm, row0[None], col0[None])]
    with pytest.raises(ValueError, match="no gotoh_fill route"):
        fill_cuda.strip_fill_block(meta[0], meta[1], meta[2], gid, go,
                                   meta[3], meta[4], [4])


# -- a world of one, in this process -----------------------------------------


@pytest.fixture(scope="module")
def world_of_one():
    multihost.initialize(num_processes=1, backend="gloo")
    try:
        yield make_pair_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("block_rows", [1, 5, 256])
def test_world_of_one_pair_cost_equals_the_fill(world_of_one, block_rows):
    scheme, letters = _scheme("dna")
    rng = np.random.default_rng(block_rows)
    cm = torch.from_numpy(_cost(scheme))
    for m, n in ((0, 7), (1, 1), (37, 80), (70, 3)):
        ta = torch.from_numpy(_tokens(scheme, _seq(rng, letters, m)))
        tb = torch.from_numpy(_tokens(scheme, _seq(rng, letters, n)))
        want = row_fill(ta, tb, cm, scheme.alphabet.gap_id,
                        scheme.gap_open_cost, want_moves=False).final3
        got = seqpar.sharded_pair_cost(
            world_of_one, ta, tb, cm, scheme.alphabet.gap_id,
            scheme.gap_open_cost, block_rows=block_rows,
        )
        assert torch.equal(got, want), (m, n)


@pytest.mark.parametrize("traceback", [False, True])
def test_world_of_one_align_pairs_equals_no_mesh(world_of_one, traceback):
    rng = np.random.default_rng(11)
    pairs = [(_seq(rng, DNA, int(rng.integers(1, 50))),
              _seq(rng, DNA, int(rng.integers(1, 50)))) for _ in range(9)]
    want = align_pairs(pairs, with_traceback=traceback, device="cpu")
    got = align_pairs(pairs, with_traceback=traceback, device="cpu",
                      mesh=world_of_one)
    assert got == want


def test_world_of_one_sharded_fills_gather_every_pair(world_of_one):
    """The mesh module's pieces on one rank: the shard is the whole batch,
    the gathered final3 equals the fill's."""
    from globalign_tpu_torch.parallel import mesh as mesh_mod

    scheme, letters = _scheme("blosum62")
    rng = np.random.default_rng(5)
    ta = np.stack([_tokens(scheme, _seq(rng, letters, 12)) for _ in range(5)])
    tb = np.stack([_tokens(scheme, _seq(rng, letters, 9)) for _ in range(5)])
    cm = torch.from_numpy(_cost(scheme))
    args = (cm, scheme.alphabet.gap_id, scheme.gap_open_cost, [12, 3, 0, 12, 7],
            [9, 9, 2, 0, 5])
    want3, want_mv = fill_cuda.batch_moves(
        torch.from_numpy(ta), torch.from_numpy(tb), *args
    )
    costs = mesh_mod.sharded_fill_costs(world_of_one, ta, tb, *args)
    shard = mesh_mod.sharded_fill_moves(world_of_one, ta, tb, *args)
    assert torch.equal(costs, want3) and torch.equal(shard.final3, want3)
    assert torch.equal(shard.moves, want_mv)
    assert shard.shard_m == args[3] and shard.shard_n == args[4]


# -- spawned gloo ranks against the JAX package -------------------------------


def _pair_case(scheme, s1, s2, block_rows):
    return dict(
        kind="pair_cost", tok_a=_tokens(scheme, s1).tolist(),
        tok_b=_tokens(scheme, s2).tolist(), cost=_cost(scheme).tolist(),
        gap_id=scheme.alphabet.gap_id, gap_open=scheme.gap_open_cost,
        block_rows=block_rows,
    )


def _seqpar_cases():
    """(label, case) pairs: the cases of tests/test_seqpar.py."""
    out = []
    dna, _ = _scheme("dna")
    for block_rows in (1, 3, 16, 64):
        rng = np.random.default_rng(block_rows)
        for k in range(2):
            s1 = _seq(rng, DNA, int(rng.integers(1, 90)))
            s2 = _seq(rng, DNA, int(rng.integers(8, 120)))
            out.append((f"dna-rb{block_rows}-{k}", _pair_case(dna, s1, s2, block_rows)))
    blosum, _ = _scheme("blosum62")
    rng = np.random.default_rng(99)
    for k in range(2):
        s1 = _seq(rng, PROTEIN, int(rng.integers(1, 70)))
        s2 = _seq(rng, PROTEIN, int(rng.integers(8, 90)))
        out.append((f"blosum62-{k}", _pair_case(blosum, s1, s2, 8)))
    gap = ("AC", "AC" + "G" * 60)  # a 60-column gap run across the strips
    out.append(("gap-across-strips", _pair_case(dna, *gap, 4)))
    out.append(("gap-down-strips", _pair_case(dna, *gap[::-1], 4)))
    out.append(("n-below-ranks", _pair_case(dna, "ACGTAC", "AG", 256)))
    return out


def _block_cases():
    """Blocks of a 21 x 37 pair, K = 8, each seeded from the one-device
    checkpoint row above it (tests/test_seqpar.py:111-164)."""
    dna, _ = _scheme("dna")
    rng = np.random.default_rng(9)
    m, n, k_rows = 21, 37, 8
    ta = _tokens(dna, _seq(rng, DNA, m))
    tb = _tokens(dna, _seq(rng, DNA, n))
    cm = _cost(dna)
    row0, col0 = jax_default_boundary(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm),
        dna.alphabet.gap_id, dna.gap_open_cost,
    )
    col0 = np.asarray(col0)
    state = np.asarray(row0)
    out = []
    for i0 in range(0, m, k_rows):
        i1 = min(i0 + k_rows, m)
        blk = np.zeros(i1 - i0 + 1, np.int32)
        blk[1:] = ta[i0 + 1 : i1 + 1]
        out.append((f"block-{i0}", dict(
            kind="block_last_rows", tok_a=blk.tolist(), tok_b=tb.tolist(),
            cost=cm.tolist(), gap_id=dna.alphabet.gap_id,
            gap_open=dna.gap_open_cost, row0=state.tolist(),
            col0=col0[:, i0 : i1 + 1].tolist(), block_rows=3,
        )))
        col0y = jnp.asarray(col0[2, i0 : i1 + 1])
        state = np.asarray(row_fill_impl(
            jnp.asarray(blk), jnp.asarray(tb), jnp.asarray(cm),
            dna.alphabet.gap_id, dna.gap_open_cost, jnp.asarray(state),
            jnp.stack([col0y, col0y, col0y]), want_moves=False,
        ).last3)
    return out


def _blocked_cases():
    rng = np.random.default_rng(31)
    dna_pair = (_seq(rng, DNA, 83), _seq(rng, DNA, 61))
    prot_pair = (_seq(rng, PROTEIN, 57), _seq(rng, PROTEIN, 70))
    return [
        ("blocked-dna", dict(kind="align_blocked", s1=dna_pair[0],
                             s2=dna_pair[1], block_rows=16)),
        ("blocked-blosum62", dict(kind="align_blocked", s1=prot_pair[0],
                                  s2=prot_pair[1], block_rows=9,
                                  scheme={"scoring_mat_name": "BLOSUM62"})),
    ]


def _pairs_cases():
    out = []
    for count in (10, 13):
        rng = np.random.default_rng(count)
        pairs = [(_seq(rng, DNA, int(rng.integers(1, 45))),
                  _seq(rng, DNA, int(rng.integers(1, 45))))
                 for _ in range(count)]
        for traceback in (False, True):
            out.append((f"pairs-{count}-tb{int(traceback)}", dict(
                kind="align_pairs", pairs=pairs, traceback=traceback,
            )))
    return out


CASES4 = _seqpar_cases() + _block_cases() + _blocked_cases() + _pairs_cases()
CASES3 = [c for c in CASES4 if c[0] in (
    "dna-rb3-0", "dna-rb16-1", "blosum62-0", "gap-across-strips",
    "n-below-ranks", "blocked-dna", "pairs-10-tb1", "pairs-13-tb0",
)]


def _answers(tmp_path_factory, world, cases):
    answers = run_ranks(
        tmp_path_factory.mktemp(f"ranks{world}"), world,
        [case for _, case in cases],
    )
    for rank, got in enumerate(answers[1:], 1):
        assert got == answers[0], f"rank {rank} differs from rank 0"
    return dict(zip((label for label, _ in cases), answers[0]))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _answers(tmp_path_factory, 4, CASES4)


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return _answers(tmp_path_factory, 3, CASES3)


@pytest.fixture(scope="module")
def strip_mesh():
    return jax_seqpar.make_strip_mesh()


def _jax_answer(case, strip_mesh, cpu_mesh):
    """The JAX package's answer to a harness case, on its 8-device mesh."""
    kind = case["kind"]
    if kind == "pair_cost":
        return np.asarray(jax_seqpar.sharded_pair_cost(
            strip_mesh, np.asarray(case["tok_a"], np.int32),
            np.asarray(case["tok_b"], np.int32),
            np.asarray(case["cost"], np.int32), case["gap_id"],
            case["gap_open"], block_rows=case["block_rows"], backend="scan",
        )).tolist()
    if kind == "block_last_rows":
        return np.asarray(jax_seqpar.sharded_block_last_rows(
            strip_mesh, np.asarray(case["tok_a"], np.int32),
            np.asarray(case["tok_b"], np.int32),
            np.asarray(case["cost"], np.int32), case["gap_id"],
            case["gap_open"], np.asarray(case["row0"], np.int32),
            np.asarray(case["col0"], np.int32),
            block_rows=case["block_rows"], backend="scan",
        )).tolist()
    if kind == "align_blocked":
        s1, s2 = case["s1"], case["s2"]
        scheme = jax_resolve_scheme(s1, s2, **case.get("scheme", {}))
        enc = [np.asarray([0, *scheme.alphabet.encode(s)], np.int32)
               for s in (s1, s2)]
        tb = jax_align_blocked(
            enc[0], jnp.asarray(enc[1]), scheme.costing.values,
            scheme.alphabet.gap_id, scheme.gap_open_cost, s1, s2,
            block_rows=case["block_rows"], use_pallas=False, mesh=strip_mesh,
        )
        return [tb.cost, tb.seq_1_aligned, tb.middle_part, tb.seq_2_aligned]
    results = jax_align_pairs(
        [tuple(p) for p in case["pairs"]], with_traceback=case["traceback"],
        mesh=cpu_mesh,
    )
    return [[r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned]
            for r in results]


@pytest.mark.parametrize("label,case", CASES4, ids=[c[0] for c in CASES4])
def test_four_ranks_match_the_jax_mesh(ranks4, strip_mesh, cpu_mesh, label, case):
    assert ranks4[label] == _jax_answer(case, strip_mesh, cpu_mesh)


@pytest.mark.parametrize("label,case", CASES3, ids=[c[0] for c in CASES3])
def test_three_ranks_match_the_jax_mesh(ranks3, strip_mesh, cpu_mesh, label, case):
    """Three ranks: strips whose widths do not divide n, a pure-pad strip."""
    assert ranks3[label] == _jax_answer(case, strip_mesh, cpu_mesh)


def test_sharded_answers_equal_the_unsharded_port(ranks4):
    """The same cases without a mesh, in this process: the plain fill, the
    unsharded blocked path and ``align_pairs``."""
    for label, case in CASES4:
        kind = case["kind"]
        if kind == "pair_cost":
            args = [torch.tensor(case[k], dtype=torch.int32)
                    for k in ("tok_a", "tok_b", "cost")]
            want = row_fill(*args, case["gap_id"], case["gap_open"],
                            want_moves=False).final3.tolist()
        elif kind == "align_blocked":
            s1, s2 = case["s1"], case["s2"]
            scheme = resolve_scheme(s1, s2, **case.get("scheme", {}))
            tb = linear_tb.align_blocked(
                *(torch.from_numpy(_tokens(scheme, s)) for s in (s1, s2)),
                torch.from_numpy(_cost(scheme)), scheme.alphabet.gap_id,
                scheme.gap_open_cost, s1, s2, block_rows=case["block_rows"],
            )
            want = [tb.cost, tb.seq_1_aligned, tb.middle_part, tb.seq_2_aligned]
        elif kind == "align_pairs":
            want = [[r.cost, r.score, r.seq_1_aligned, r.middle_part,
                     r.seq_2_aligned] for r in align_pairs(
                [tuple(p) for p in case["pairs"]],
                with_traceback=case["traceback"], device="cpu")]
        else:
            continue
        assert ranks4[label] == want, label
