"""The port's batch path held against the JAX package's, on the CPU.

``globalign_tpu_torch.batch.align_pairs(device="cpu")`` (bucketing, the
plain versions of the batch kernels, the op-tape render) and
``ops.fill_batch.batch_final3`` on CPU tensors, fed the same seeded inputs
as the JAX package's ``align_pairs`` and the two Pallas kernels that
``gotoh_batch`` replaces (#7 ``row_fill_last_rows_batch`` and #8
``stacked_uniform_fill_last_rows``, in interpret mode).  The cases of
``tests/test_batch.py`` that do not exercise the chunk-fusion machinery
(which is not ported) are mirrored here.

Tolerance 0: costs, scores and DP lanes are integers, alignments strings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalign_tpu import align_pairs as jax_align_pairs
from globalign_tpu import batch as jax_batch
from globalign_tpu import find_global_alignment as jax_find
from globalign_tpu.ops import fill_pallas
from globalign_tpu.ops.linear_tb import assemble_from_tapes
from globalign_tpu_torch import align_pairs, find_global_alignment
from globalign_tpu_torch import batch as batch_mod
from globalign_tpu_torch.batch import PairResult, bucket_length
from globalign_tpu_torch.ops import fill_batch, fill_cuda, linear_tb
from globalign_tpu_torch.ops.fill_scan import BIG
from globalign_tpu_torch.ops.traceback import alignment_cost
from globalign_tpu_torch.utils.matrices import SubstitutionMatrix

PAIRS = [  # tests/test_batch.py:10-18
    ("ACGT", "AGT"),
    ("TT", "TA"),
    ("TAAAGCTAA", "TAGCTC"),
    ("GGAGGACGTT", "GAG"),
    ("TGGATGAGGCTCCACGCACTAA", "GATTGGTGAGGCTCAGCAT"),
    ("A", "TTTTTTTT"),
    ("ACGTACGTACGTACGTACGTACGTACGTACGTACGT", "ACGT"),  # crosses a bucket edge
]
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
SCHEMES = {
    "dna": ("ACGT", {}),
    "custom": ("ACGT", dict(match_score=3, mismatch_score=-4,
                            gap_open_score=-5, gap_extension_score=-2)),
    "blosum62": (PROTEIN, dict(scoring_mat_name="BLOSUM62")),
}


def _fields(results):
    return [
        (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
        for r in results
    ]


def _ragged_pairs(rng, letters, count, lo=1, hi=96):
    """Pairs of lengths in [lo, hi]: with quantum 32, at most 3 x 3 buckets."""
    return [
        tuple(
            "".join(rng.choice(list(letters), int(rng.integers(lo, hi + 1))))
            for _ in range(2)
        )
        for _ in range(count)
    ]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- align_pairs against the JAX package ------------------------------------


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_align_pairs_matches_jax(scheme, with_traceback):
    letters, kw = SCHEMES[scheme]
    rng = np.random.default_rng(len(scheme) + with_traceback)
    pairs = _ragged_pairs(rng, letters, 14, lo=1, hi=90)
    pairs[3] = (pairs[3][0].lower(), pairs[3][1])  # upper-cased on input
    want = jax_align_pairs(pairs, with_traceback=with_traceback, **kw)
    got = align_pairs(pairs, with_traceback=with_traceback, device="cpu", **kw)
    assert _fields(got) == _fields(want)
    assert all(isinstance(r, PairResult) for r in got)


@pytest.mark.parametrize("quantum", [8, 32, 128])
def test_align_pairs_bucket_quantum_matches_jax(quantum):
    rng = np.random.default_rng(quantum)
    pairs = _ragged_pairs(rng, "ACGT", 9, lo=1, hi=64)
    want = jax_align_pairs(pairs, bucket_quantum=quantum)
    assert _fields(align_pairs(pairs, bucket_quantum=quantum, device="cpu")) == (
        _fields(want)
    )


def test_align_pairs_with_a_resolved_scheme_and_cigar():
    from globalign_tpu_torch import resolve_scheme

    scheme = resolve_scheme("ACGT", "ACGT", mismatch_cost=9)
    got = align_pairs([("ACGT", "AGT"), ("GATTACA", "GCATGCT")], scheme=scheme,
                      device="cpu")
    want = jax_align_pairs([("ACGT", "AGT"), ("GATTACA", "GCATGCT")],
                           mismatch_cost=9)
    assert _fields(got) == _fields(want)
    assert [r.cigar() for r in got] == [r.cigar() for r in want]
    assert got[0].cigar(extended=False) == want[0].cigar(extended=False)
    assert align_pairs([("ACGT", "AGT")], with_traceback=False,
                       device="cpu")[0].cigar() is None


def test_align_pairs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        align_pairs([("ACGT", "AGT")])


# -- tests/test_batch.py:21-130, mirrored -----------------------------------


@pytest.mark.parametrize("length,quantum,want", [
    (1, 32, 32), (32, 32, 32), (33, 32, 64), (150, 32, 160), (150, 7, 154),
])
def test_bucket_length(length, quantum, want):
    assert bucket_length(length, quantum) == want
    assert jax_batch.bucket_length(length, quantum) == want


@pytest.mark.parametrize("idx", range(len(PAIRS)))
def test_align_pairs_matches_single_pair_api(idx):
    batched = align_pairs(PAIRS, device="cpu")[idx]
    s1, s2 = PAIRS[idx]
    single = find_global_alignment(seq_1=s1, seq_2=s2, device="cpu")
    jax_single = jax_find(seq_1=s1, seq_2=s2)
    assert (batched.cost, batched.score) == (single.cost, single.score) == (
        jax_single.cost, jax_single.score
    )
    # Deterministic engine: batched and single tracebacks are identical.
    assert (batched.seq_1_aligned, batched.middle_part, batched.seq_2_aligned) == (
        single.seq_1_aligned, single.middle_part, single.seq_2_aligned
    )


def test_align_pairs_cost_only():
    costs = align_pairs(PAIRS, with_traceback=False, device="cpu")
    full = align_pairs(PAIRS, with_traceback=True, device="cpu")
    for c, f in zip(costs, full):
        assert (c.cost, c.score) == (f.cost, f.score)
        assert c.seq_1_aligned is c.middle_part is c.seq_2_aligned is None


def test_align_pairs_custom_scheme():
    batched = align_pairs(
        [("TT", "TA"), ("GGAGGACGTT", "GAG")],
        match_score=3,
        mismatch_score=-4,
        gap_open_score=-5,
        gap_extension_score=-2,
        device="cpu",
    )
    assert (batched[0].score, batched[0].cost) == (-1, 7)


@pytest.mark.parametrize("pair", [("MKV", "MKV"), ("HEAGAWGHEE", "PAWHEAE")])
def test_align_pairs_blosum(pair):
    r = align_pairs([pair], scoring_mat_name="BLOSUM62", device="cpu")[0]
    single = find_global_alignment(
        seq_1=pair[0], seq_2=pair[1], scoring_mat_name="BLOSUM62", device="cpu"
    )
    assert (r.cost, r.score) == (single.cost, single.score)
    costing = SubstitutionMatrix.from_nested_dict(single.costing_mat)
    assert alignment_cost(
        r.seq_1_aligned, r.seq_2_aligned, costing, single.gap_open_cost
    ) == r.cost


@pytest.mark.parametrize("pairs,message", [
    ([("", "ACGT")], "Pair 0: detected a sequence of length 0."),
    ([("ACGT", "AC"), ("AC-T", "ACGT")],
     "Pair 1: sequences may not contain the '-' character."),
    ([("ACGT", "")], "Pair 0: detected a sequence of length 0."),
])
def test_align_pairs_validation_messages_match_jax(pairs, message):
    with pytest.raises(RuntimeError) as jax_err:
        jax_align_pairs(pairs)
    with pytest.raises(RuntimeError) as port_err:
        align_pairs(pairs, device="cpu")
    assert str(port_err.value) == str(jax_err.value) == message
    assert align_pairs([], device="cpu") == []


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_batch_traceback_moves_budget_fallback(monkeypatch):
    """Pairs whose codes alone exceed the budget go through the blocked
    per-pair traceback and still produce identical alignments."""
    rng = np.random.default_rng(3)
    pairs = _ragged_pairs(rng, "ACGT", 3, lo=70, hi=80)
    want = jax_align_pairs(pairs, with_traceback=True)
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", 64)
    blocked = _count_calls(monkeypatch, linear_tb, "align_blocked")
    fills = _count_calls(monkeypatch, fill_cuda, "batch_moves")
    got = align_pairs(pairs, with_traceback=True, device="cpu")
    assert _fields(got) == _fields(want)
    assert len(blocked) == 3 and not fills


def test_batch_traceback_subbatch_split(monkeypatch):
    """A bucket over the moves budget is split into segments (one ragged
    fill and one ragged walk each), each closed where its codes, in the
    ragged layout (``fill_cuda.ragged_bytes``), would pass the budget —
    not degraded to per-pair replay."""
    rng = np.random.default_rng(7)
    pairs = _ragged_pairs(rng, "ACGT", 5, lo=20, hi=30)  # one 32 x 32 bucket
    want = jax_align_pairs(pairs, with_traceback=True)
    budget = 2 * fill_cuda.ragged_bytes(32, 32) + 5  # two padded pairs
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", budget)
    segments, used = [0], 0
    for a, b in pairs:
        size = fill_cuda.ragged_bytes(len(a), len(b))
        if used + size > budget:
            segments.append(0)
            used = 0
        segments[-1] += 1
        used += size
    blocked = _count_calls(monkeypatch, linear_tb, "align_blocked")
    per_bucket = _count_calls(monkeypatch, fill_cuda, "batch_moves")
    fills = _count_calls(monkeypatch, fill_cuda, "batch_moves_ragged")
    walks = _count_calls(monkeypatch, linear_tb, "walk_ragged")
    got = align_pairs(pairs, with_traceback=True, device="cpu")
    assert _fields(got) == _fields(want)
    assert not blocked and not per_bucket and len(segments) > 1
    assert [sum(t.shape[0] for t in f[0]) for f in fills] == segments
    assert len(walks) == len(segments)


def test_the_card_budget_governs_device_walked_buckets(monkeypatch):
    """On the card every traceback sub-batch is walked where it lies, under
    DEVICE_WALK_MOVES_BUDGET; on the CPU, DEFAULT_BATCH_MOVES_BUDGET."""
    assert batch_mod._moves_budget(torch.device("cpu")) == (
        batch_mod.DEFAULT_BATCH_MOVES_BUDGET
    )
    assert batch_mod._moves_budget(torch.device("cuda", 0)) == (
        batch_mod.DEVICE_WALK_MOVES_BUDGET
    ) == 1536 * 1024 * 1024
    assert batch_mod.DEFAULT_BATCH_MOVES_BUDGET == (
        jax_batch.DEFAULT_BATCH_MOVES_BUDGET
    )
    assert batch_mod.DEVICE_WALK_MOVES_BUDGET == jax_batch.DEVICE_WALK_MOVES_BUDGET


@pytest.mark.parametrize("card_bytes, want_segments", [
    (80 << 30, 1),  # an 80 GB card: a quarter, ~21 GB, holds 16 genomes
    (4 << 30, 16),  # a quarter under 1536 MiB: the moves budget, a genome each
])
def test_a_segment_holds_a_quarter_of_the_card(monkeypatch, card_bytes,
                                               want_segments):
    """On the card an unsharded traceback segment may hold a quarter of its
    total memory, never less than DEVICE_WALK_MOVES_BUDGET: 16 pairs of
    29 903 x ~29 903 (896 MB of codes each) are one segment on an 80 GB
    card and 16 on a small one, and none of them goes blocked."""
    monkeypatch.setattr(batch_mod, "_card_memory", lambda index: card_bytes)
    card = torch.device("cuda", 0)
    capacity = batch_mod._segment_budget(card)
    assert capacity == max(batch_mod.DEVICE_WALK_MOVES_BUDGET, card_bytes // 4)
    assert batch_mod._moves_budget(card) == batch_mod.DEVICE_WALK_MOVES_BUDGET
    rng = np.random.default_rng(29903)
    m_true = [29903] * 16
    n_true = (29903 + rng.integers(-12, 13, 16)).tolist()
    key = (bucket_length(29903), bucket_length(max(n_true)))
    assert fill_cuda.ragged_bytes(*key) <= batch_mod._moves_budget(card)
    segments = batch_mod._segments([(m_true, n_true)], capacity)
    assert len(segments) == want_segments
    assert [run for seg in segments for run in seg] == (
        [(0, 0, 16)] if want_segments == 1 else [(0, k, k + 1) for k in range(16)]
    )


def test_the_cpu_segment_capacity_is_the_moves_budget():
    """Off the card the segment capacity is DEFAULT_BATCH_MOVES_BUDGET, the
    bound of the host memory the codes take there."""
    assert batch_mod._segment_budget(torch.device("cpu")) == (
        batch_mod.DEFAULT_BATCH_MOVES_BUDGET
    )


def test_blocked_pairs_keep_the_moves_budget_under_a_larger_segment(monkeypatch):
    """The two bounds apart: a bucket whose padded pair passes the moves
    budget goes blocked however large the segment capacity, and the other
    pairs, whose codes together pass the moves budget, fill in one segment;
    the results equal the JAX package's."""
    rng = np.random.default_rng(5)
    short = _ragged_pairs(rng, "ACGT", 6, lo=20, hi=30)
    long = _ragged_pairs(rng, "ACGT", 2, lo=70, hi=80)
    pairs = short[:3] + long[:1] + short[3:] + long[1:]
    want = jax_align_pairs(pairs, with_traceback=True)
    budget = fill_cuda.ragged_bytes(40, 40)  # over a 32 x 32 pair, under 96 x 96
    assert sum(fill_cuda.ragged_bytes(len(a), len(b)) for a, b in short) > budget
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", budget)
    monkeypatch.setattr(batch_mod, "_segment_budget", lambda device: 1 << 40)
    blocked = _count_calls(monkeypatch, linear_tb, "align_blocked")
    fills = _count_calls(monkeypatch, fill_cuda, "batch_moves_ragged")
    walks = _count_calls(monkeypatch, linear_tb, "walk_ragged")
    got = align_pairs(pairs, with_traceback=True, device="cpu")
    assert _fields(got) == _fields(want)
    assert len(blocked) == 2 and len(walks) == 1
    assert [sum(t.shape[0] for t in f[0]) for f in fills] == [6]


@pytest.mark.parametrize("with_traceback", [False, True])
def test_one_fill_per_bucket(monkeypatch, with_traceback):
    """Cost-only: one ragged fill a call, over every bucket; traceback: one
    ragged moves fill and one ragged walk a segment (one segment under the
    default budget), over every bucket — never a launch per bucket or per
    pair."""
    rng = np.random.default_rng(11)
    pairs = _ragged_pairs(rng, "ACGT", 16, lo=1, hi=90)
    buckets = {(bucket_length(len(a)), bucket_length(len(b))) for a, b in pairs}
    assert len(buckets) > 1
    ragged = _count_calls(monkeypatch, fill_batch, "batch_final3_ragged")
    finals = _count_calls(monkeypatch, fill_batch, "batch_final3")
    fills = _count_calls(monkeypatch, fill_cuda, "batch_moves")
    walks = _count_calls(monkeypatch, linear_tb, "walk_block")
    ragged_fills = _count_calls(monkeypatch, fill_cuda, "batch_moves_ragged")
    ragged_walks = _count_calls(monkeypatch, linear_tb, "walk_ragged")
    align_pairs(pairs, with_traceback=with_traceback, device="cpu")
    want = (0, 0, 0, 0, 1, 1) if with_traceback else (1, 0, 0, 0, 0, 0)
    assert (len(ragged), len(finals), len(fills), len(walks),
            len(ragged_fills), len(ragged_walks)) == want
    # the call's buckets, each in one tensor pair
    call = ragged_fills[0] if with_traceback else ragged[0]
    assert len(call[0]) == len(buckets)
    assert sorted(t.shape[1] - 1 for t in call[1]) == sorted(
        n for _, n in buckets
    )


@pytest.mark.parametrize("with_traceback", [False, True])
def test_flush_false_resolves_to_the_flushed_results(with_traceback):
    rng = np.random.default_rng(21)
    pairs = _ragged_pairs(rng, "ACGT", 12, lo=1, hi=90)
    want = align_pairs(pairs, with_traceback=with_traceback, device="cpu")
    phases = {}
    pending = align_pairs(pairs, with_traceback=with_traceback, device="cpu",
                          flush=False, phase_seconds=phases)
    assert isinstance(pending, batch_mod.PendingAlignments)
    assert "fetch" not in phases  # nothing fetched before resolve()
    assert _fields(pending.resolve()) == _fields(want)
    assert "fetch" in phases and ("traceback" in phases) == with_traceback


def test_alignment_to_pair_result():
    from globalign_tpu_torch import GotohAligner, resolve_scheme

    scheme = resolve_scheme("ACGT", "AGT")
    a = GotohAligner(scheme, device="cpu").align("ACGT", "AGT")
    r = batch_mod.alignment_to_pair_result(a)
    assert (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned) == (
        7, 0, "ACGT", "| ||", "A-GT"
    )


# -- batch_final3: the plain version against TPU kernels #7 and #8 ----------


def _uniform_costing(A, cmatch, cmismatch, dcost, icost):
    """Costing matrix over 1-origin tokens 1..A with gap id A+1."""
    gid = A + 1
    cm = np.full((A + 2, A + 2), cmismatch, np.int32)
    np.fill_diagonal(cm, cmatch)
    cm[gid, :] = dcost
    cm[:, gid] = icost
    cm[gid, gid] = 0
    return cm, gid


def _batch(rng, B, m_pad, n_pad, toks, m_true=None):
    ta = rng.choice(toks, (B, m_pad + 1)).astype(np.int32)
    tb = rng.choice(toks, (B, n_pad + 1)).astype(np.int32)
    ta[:, 0] = 0
    tb[:, 0] = 0
    mt = rng.integers(1, m_pad + 1, B).astype(np.int32) if m_true is None else (
        np.asarray(m_true, np.int32)
    )
    nt = rng.integers(1, n_pad + 1, B).astype(np.int32)
    return ta, tb, mt, nt


def _assert_last_rows_match(got, want, mt, nt):
    """Every column up to n_true of each pair's row m_true, and final3."""
    final3 = fill_batch.batch_final3(*got)
    last = fill_batch.batch_final3(*got, last_rows=True)
    for b in range(len(nt)):
        n = int(nt[b])
        assert (np.asarray(want[b])[:, : n + 1] == last[b, :, : n + 1].numpy()).all(), b
        assert (final3[b].numpy() == np.asarray(want[b])[:, n]).all(), b


@pytest.mark.parametrize("m_true", [None, [0, 5, 64, 1, 33, 64, 0, 17]])
def test_batch_final3_matches_stacked_uniform_kernel(m_true):
    """TPU kernel #8 (``stacked_uniform_fill_last_rows``, B = 8, uniform
    scheme) in interpret mode, ragged lengths, m_true = 0 included."""
    rng = np.random.default_rng(61)
    cmatch, cmismatch, dcost, icost, go = 0, 5, 3, 2, 4
    cm, gid = _uniform_costing(4, cmatch, cmismatch, dcost, icost)
    ta, tb, mt, nt = _batch(rng, 8, 64, 40, [1, 2, 3, 4], m_true)
    want = fill_pallas.stacked_uniform_fill_last_rows(
        jnp.asarray(ta), jnp.asarray(tb), cmatch, cmismatch, dcost, icost, go,
        jnp.asarray(mt), jnp.asarray(nt), interpret=True,
    )
    _assert_last_rows_match((_t(ta), _t(tb), _t(cm), gid, go, mt, nt),
                            want, mt, nt)


def test_batch_final3_matches_grid_per_pair_kernel():
    """TPU kernel #7 (``row_fill_last_rows_batch``, any matrix, B = 5) in
    interpret mode: a random non-uniform matrix, gap id in the middle."""
    rng = np.random.default_rng(62)
    A, gid, go = 7, 3, 5
    cm = rng.integers(0, 11, (A, A)).astype(np.int32)
    cm[gid, gid] = 0
    toks = [c for c in range(A) if c != gid]
    ta, tb, mt, nt = _batch(rng, 5, 30, 50, toks, [30, 0, 12, 1, 29])
    want = fill_pallas.row_fill_last_rows_batch(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
        jnp.int32(go), jnp.asarray(mt), jnp.asarray(nt), interpret=True,
    )
    _assert_last_rows_match((_t(ta), _t(tb), _t(cm), gid, go, mt, nt),
                            want, mt, nt)


def test_batch_final3_matches_jax_batch_final3_on_boundary_pairs():
    """Zero-column pairs and m_true = 0: the boundary rows, as JAX
    ``batch_final3`` (the grid-per-pair kernel, interpret mode) gives."""
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    ta = np.array([[0, 1, 2, 3], [0, 4, 4, 1], [0, 2, 0, 0]], np.int32)
    tb = np.array([[0, 3, 1], [0, 2, 2], [0, 1, 4]], np.int32)
    mt, nt = np.array([3, 0, 1], np.int32), np.array([0, 2, 2], np.int32)
    want = np.asarray(fill_pallas.batch_final3(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid),
        jnp.int32(4), jnp.asarray(mt), jnp.asarray(nt), interpret=True,
    ))
    got = fill_batch.batch_final3(_t(ta), _t(tb), _t(cm), gid, 4, mt, nt)
    assert (got.numpy() == want).all()


def test_batch_final3_checks_its_inputs_and_has_no_other_route():
    cm, gid = _uniform_costing(4, 0, 5, 3, 2)
    ta = torch.ones((2, 9), dtype=torch.int32)
    tb = torch.ones((2, 7), dtype=torch.int32)
    assert fill_batch.batch_final3(ta, tb, _t(cm), gid, 4, [8, 2], [6, 0]).shape == (2, 3)
    with pytest.raises(ValueError, match="lie in"):
        fill_batch.batch_final3(ta, tb, _t(cm), gid, 4, [9, 2], [6, 0])
    with pytest.raises(TypeError, match="int32"):
        fill_batch.batch_final3(ta.long(), tb, _t(cm), gid, 4, [8, 2], [6, 0])
    meta = [torch.ones(x.shape, dtype=torch.int32, device="meta")
            for x in (ta, tb, _t(cm))]
    before = fill_batch.batch_final3.launches
    with pytest.raises(ValueError, match="no batch_final3 route"):
        fill_batch.batch_final3(*meta, gid, 4, [8, 2], [6, 0])
    assert fill_batch.batch_final3.launches == before


@pytest.mark.parametrize("n_cols,alphabet,want", [
    (1024, 5, 32),  # the serving chunk's widest bucket
    (1000, 61, 32),  # the 60-letter table
    (512, 25, 16),
    (513, 25, 32),
    (129, 5, 8),
    (128, 5, 4),
    (0, 5, 4),
    (1025, 5, None),  # past the width cap: gotoh_fill
    (4096, 5, None),
    (64, 257, None),  # tokens are bytes in registers
    (64, 242, None),  # a table past a block's shared memory
    (64, 241, 4),
])
def test_gotoh_batch_plan(n_cols, alphabet, want):
    """plan() routes by width and table alone: W is the narrowest instance
    that holds the columns, up to the 1024-column cap."""
    width = fill_batch.plan(n_cols, alphabet)
    assert width == want
    if width is not None:
        assert width * 32 >= n_cols and width in fill_batch.WIDTHS
        assert width == 4 or width * 16 < n_cols
        assert 4 * alphabet**2 <= fill_batch.SMEM_OPTIN
    assert fill_batch.MAX_COLUMNS == 1024


@pytest.mark.parametrize("n_cols,want", [
    (0, 4), (1, 4), (128, 4), (129, 8), (256, 8), (257, 16), (512, 16),
    (513, 32), (1024, 32),
])
def test_width_class(n_cols, want):
    assert fill_batch.width_class(n_cols) == want


def test_width_class_refuses_past_the_cap():
    with pytest.raises(ValueError, match="exceed"):
        fill_batch.width_class(1025)


def _scheme_costs(name):
    """(cost matrix, gap id, gap open, token choices) of a named scheme."""
    from globalign_tpu_torch import resolve_scheme

    letters, kw = {
        "dna": ("ACGT", {}),
        "blosum62": (PROTEIN, dict(scoring_mat_name="BLOSUM62")),
        # odd max score: dcost != icost
        "odd": ("ACGT", dict(match_score=3, mismatch_score=-2,
                             gap_open_score=-5, gap_extension_score=-1)),
    }[name]
    scheme = resolve_scheme(letters, letters, **kw)
    gid = scheme.alphabet.gap_id
    cm = np.ascontiguousarray(scheme.costing.values, np.int32)
    toks = [t for t in range(scheme.alphabet.size) if t != gid]
    return cm, gid, scheme.gap_open_cost, toks


@pytest.mark.parametrize("scheme", ["dna", "blosum62", "odd"])
def test_batch_final3_ragged_matches_jax_bucket_by_bucket(scheme):
    """The ragged entry on CPU tensors over three buckets (lengths 0 and 1
    among them) against JAX ``batch_final3`` and TPU kernel #7
    (``row_fill_last_rows_batch``) in interpret mode, bucket by bucket:
    final3 and every column of the last rows, tolerance 0."""
    cm, gid, go, toks = _scheme_costs(scheme)
    rng = np.random.default_rng(len(scheme))
    shapes = [(64, 64, [64, 0, 1, 33], [0, 64, 1, 17]),
              (8, 40, [8, 5, 1], [40, 1, 0]),
              (33, 2, [33, 20], [2, 1])]
    buckets = []
    for m_pad, n_pad, mt, nt in shapes:
        ta, tb, mt, _ = _batch(rng, len(mt), m_pad, n_pad, toks, mt)
        buckets.append((ta, tb, mt, np.asarray(nt, np.int32)))
    args = ([_t(b[0]) for b in buckets], [_t(b[1]) for b in buckets], _t(cm),
            gid, go, [b[2] for b in buckets], [b[3] for b in buckets])
    final3 = fill_batch.batch_final3_ragged(*args)
    lasts = fill_batch.batch_final3_ragged(*args, last_rows=True)
    assert final3.shape == (sum(len(b[2]) for b in buckets), 3)
    lo = 0
    for (ta, tb, mt, nt), last in zip(buckets, lasts):
        jargs = (jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm),
                 jnp.int32(gid), jnp.int32(go), jnp.asarray(mt), jnp.asarray(nt))
        want3 = np.asarray(fill_pallas.batch_final3(*jargs, interpret=True))
        assert (final3[lo : lo + len(mt)].numpy() == want3).all()
        want_rows = np.asarray(
            fill_pallas.row_fill_last_rows_batch(*jargs, interpret=True)
        )
        assert last.shape == (len(mt), 3, tb.shape[1])
        for b, n in enumerate(nt.tolist()):
            assert (last[b, :, : n + 1].numpy() == want_rows[b, :, : n + 1]).all()
            assert (last[b, :, n + 1 :] == BIG).all()
        lo += len(mt)


def test_batch_final3_is_the_ragged_entry_on_one_bucket():
    cm, gid, go, toks = _scheme_costs("dna")
    ta, tb, mt, nt = _batch(np.random.default_rng(5), 6, 20, 30, toks)
    args = (_t(ta), _t(tb), _t(cm), gid, go, mt, nt)
    assert torch.equal(
        fill_batch.batch_final3(*args),
        fill_batch.batch_final3_ragged([args[0]], [args[1]], *args[2:5], [mt], [nt]),
    )
    assert torch.equal(
        fill_batch.batch_final3(*args, last_rows=True),
        fill_batch.batch_final3_ragged([args[0]], [args[1]], *args[2:5], [mt],
                                       [nt], last_rows=True)[0],
    )


def test_batch_final3_ragged_checks_its_buckets():
    cm, gid, go, _ = _scheme_costs("dna")
    ta = torch.ones((2, 9), dtype=torch.int32)
    tb = torch.ones((2, 7), dtype=torch.int32)
    with pytest.raises(ValueError, match="same buckets"):
        fill_batch.batch_final3_ragged([ta], [tb, tb], _t(cm), gid, go,
                                       [[8, 2]], [[6, 0]])
    with pytest.raises(ValueError, match="same buckets"):
        fill_batch.batch_final3_ragged([], [], _t(cm), gid, go, [], [])
    with pytest.raises(ValueError, match="lie in"):
        fill_batch.batch_final3_ragged([ta, ta], [tb, tb], _t(cm), gid, go,
                                       [[8, 2], [9, 2]], [[6, 0], [6, 0]])
    meta = torch.ones((2, 9), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        fill_batch.batch_final3_ragged([ta, meta], [tb, tb], _t(cm), gid, go,
                                       [[8, 2], [8, 2]], [[6, 0], [6, 0]])


@pytest.mark.parametrize("quantum", [16, 32])
def test_align_pairs_cost_only_fused_matches_jax(monkeypatch, quantum):
    """Cost-only align_pairs over many buckets (one ragged fill) equal to
    the JAX package's align_pairs on the CPU, DNA and BLOSUM62."""
    rng = np.random.default_rng(40 + quantum)
    for letters, kw in (("ACGT", {}), (PROTEIN, dict(scoring_mat_name="BLOSUM62"))):
        pairs = _ragged_pairs(rng, letters, 16, lo=1, hi=70)
        want = jax_align_pairs(pairs, with_traceback=False, bucket_quantum=quantum,
                               **kw)
        ragged = _count_calls(monkeypatch, fill_batch, "batch_final3_ragged")
        got = align_pairs(pairs, with_traceback=False, bucket_quantum=quantum,
                          device="cpu", **kw)
        assert len(ragged) == 1 and len(ragged[0][0]) > 3
        assert _fields(got) == _fields(want)
        monkeypatch.undo()


# -- the op-tape render against the JAX package's Python assembly -----------


@pytest.mark.parametrize("seed", range(4))
def test_render_ops_matches_assemble_from_tapes(seed):
    """Tapes from real fills and walks (plain versions), rendered forward
    (and by ``render_walk`` from the walk-order tape) and assembled
    backward by the JAX package: byte-identical, one pair or many at
    once."""
    rng = np.random.default_rng(seed)
    letters = "ACGT" if seed % 2 else PROTEIN
    pairs = _ragged_pairs(rng, letters, 6, lo=1, hi=60)
    pairs.append(("A", "CCCCCGGG"))  # a walk that leaves row-0 left moves
    fwd, want = [], []
    for s1, s2 in pairs:
        from globalign_tpu_torch import resolve_scheme

        scheme = resolve_scheme(s1, s2)
        enc = [np.r_[0, scheme.alphabet.encode(s)].astype(np.int32) for s in (s1, s2)]
        args = (_t(enc[0])[None], _t(enc[1])[None],
                _t(np.asarray(scheme.costing.values, np.int32)),
                scheme.alphabet.gap_id, scheme.gap_open_cost, [len(s1)], [len(s2)])
        final3, moves = fill_cuda.batch_moves(*args)
        ops, count, j_exit, _ = linear_tb.walk_block(
            moves, [len(s1)], torch.tensor([len(s2)], dtype=torch.int32),
            final3.argmin(-1).to(torch.int32),
        )
        tape = ops[0, : int(count[0])].numpy()
        want.append(assemble_from_tapes([tape], s1, s2))
        fwd.append(np.r_[np.full(int(j_exit[0]), linear_tb.OP_LEFT, np.uint8),
                         tape[::-1]])
        assert linear_tb.render_ops(fwd[-1], s1, s2) == want[-1]
        assert linear_tb.render_walk(tape, int(j_exit[0]), s1, s2) == want[-1]
    assert linear_tb.render_many(
        fwd, [p[0] for p in pairs], [p[1] for p in pairs]
    ) == want


def test_render_handles_any_characters_and_empty_tapes():
    wide = "".join(chr(0x4E00 + k) for k in range(3))
    ops = np.array([1, 0, 2, 0], np.uint8)
    assert linear_tb.render_ops(ops, wide, "AB" + wide[2]) == (
        assemble_from_tapes([ops[::-1]], wide, "AB" + wide[2])
    )
    assert linear_tb.render_many([], [], []) == []
    assert linear_tb.render_ops(np.zeros(0, np.uint8), "", "") == ("", "", "")
    with pytest.raises(ValueError, match="whole sequence"):
        linear_tb.render_ops(np.array([0], np.uint8), "AC", "A")


@pytest.mark.parametrize("seqs", [
    ["ACGT", "A", "TTTTGGGG", "C"],
    ["HEAGAWGHEE", "PAWHEAE", "MKV"],
    ["一丁", "丁"],  # past ASCII: the per-sequence path
])
def test_encode_bucket_matches_encode_padded(seqs):
    from globalign_tpu_torch.utils.tokenize import Alphabet, encode_padded

    alphabet = Alphabet.from_sequences(*seqs)
    got = batch_mod._encode_bucket(alphabet, seqs, 12)
    assert got.dtype == np.int32 and got.shape == (len(seqs), 13)
    for row, seq in enumerate(seqs):
        assert (got[row] == encode_padded(alphabet, seq, 12)).all()


def test_encode_bucket_names_an_unknown_character():
    from globalign_tpu_torch.utils.tokenize import Alphabet

    with pytest.raises(ValueError, match="'N' not present"):
        batch_mod._encode_bucket(Alphabet.from_sequences("ACGT"), ["ACG", "ANT"], 4)


# -- ROADMAP C5: non-ASCII letters (the JAX native layer's fault) ----------

UNICODE_LETTERS = "ΩЖ字A"
UNICODE_MTX = (
    "# a custom scoring matrix over non-ASCII letters\n"
    "Ω Ж 字 A -\n"
    "Ω 4 -2 -3 -1 -3\n"
    "Ж -2 5 -1 -3 -3\n"
    "字 -3 -1 4 -2 -3\n"
    "A -1 -3 -2 5 -3\n"
    "- -3 -3 -3 -3 4\n"
)


@pytest.fixture
def unicode_mtx(tmp_path):
    path = tmp_path / "unicode.mtx"
    path.write_text(UNICODE_MTX, encoding="utf-8")
    return path


@pytest.mark.parametrize("with_traceback", [False, True])
def test_align_pairs_non_ascii_matches_jax_without_native(
    monkeypatch, unicode_mtx, with_traceback
):
    """``align_pairs`` under a non-ASCII custom matrix equals JAX
    ``align_pairs`` with the JAX native layer off, in both modes, across
    several buckets."""
    from globalign_tpu.utils import native

    monkeypatch.setattr(native, "load", lambda: None)
    rng = np.random.default_rng(53 + with_traceback)
    pairs = _ragged_pairs(rng, UNICODE_LETTERS, 12, lo=1, hi=80)
    want = jax_align_pairs(pairs, with_traceback=with_traceback,
                           scoring_mat_path=unicode_mtx)
    got = align_pairs(pairs, with_traceback=with_traceback, device="cpu",
                      scoring_mat_path=unicode_mtx)
    assert _fields(got) == _fields(want)
    if with_traceback:
        assert [r.cigar() for r in got] == [r.cigar() for r in want]


def test_align_pairs_non_ascii_blocked_matches_jax_without_native(
    monkeypatch, unicode_mtx
):
    """Traceback pairs past a lowered batch budget go through the blocked
    per-pair traceback and equal JAX (native off) under the matrix."""
    from globalign_tpu.utils import native

    monkeypatch.setattr(native, "load", lambda: None)
    rng = np.random.default_rng(59)
    pairs = _ragged_pairs(rng, UNICODE_LETTERS, 3, lo=60, hi=80)
    want = jax_align_pairs(pairs, with_traceback=True,
                           scoring_mat_path=unicode_mtx)
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", 64)
    blocked = _count_calls(monkeypatch, linear_tb, "align_blocked")
    got = align_pairs(pairs, with_traceback=True, device="cpu",
                      scoring_mat_path=unicode_mtx)
    assert _fields(got) == _fields(want)
    assert len(blocked) == 3


def test_jax_align_pairs_native_fails_on_non_ascii(unicode_mtx):
    """ROADMAP C5, recorded: JAX ``align_pairs(with_traceback=True)``
    renders through its native layer, which reads UTF-8 bytes as letters:
    it raises, or its strings differ from the port's.  Cost-only results
    agree."""
    from globalign_tpu.utils import native

    rng = np.random.default_rng(53)
    pairs = _ragged_pairs(rng, UNICODE_LETTERS, 12, lo=1, hi=80)
    got = align_pairs(pairs, with_traceback=True, device="cpu",
                      scoring_mat_path=unicode_mtx)
    costs = jax_align_pairs(pairs, with_traceback=False,
                            scoring_mat_path=unicode_mtx)
    assert [r.cost for r in costs] == [r.cost for r in got]
    try:
        want = jax_align_pairs(pairs, with_traceback=True,
                               scoring_mat_path=unicode_mtx)
    except UnicodeDecodeError:
        assert native.available()
        return
    assert (_fields(want) != _fields(got)) == native.available()
