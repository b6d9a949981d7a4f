"""The traceback buckets of a call together: ragged fill and walk, on the CPU.

``ops.fill_cuda.batch_moves_ragged`` and ``ops.linear_tb.walk_ragged`` on
CPU tensors (their plain versions: the row scan and the walk pair by pair,
through the packed buffer, offsets and strides the kernels take) against
the per-bucket ``batch_moves`` and ``walk_block``; the launch classes and
offsets (pure numpy); and ``align_pairs(with_traceback=True, device="cpu")``
in several segments against the JAX package's ``align_pairs``, the
counterpart of its chunk-wide device walk (``_lanes_walk_fills``,
``_mega_walk_flush``).

Tolerance 0: final lanes, codes, tapes and costs are integers, alignments
strings.
"""

import numpy as np
import pytest
import torch

from globalign_tpu import align_pairs as jax_align_pairs
from globalign_tpu_torch import align_pairs, resolve_scheme
from globalign_tpu_torch import batch as batch_mod
from globalign_tpu_torch.batch import bucket_length
from globalign_tpu_torch.ops import fill_cuda, linear_tb

PROTEIN = "ARNDCQEGHILKMFPSTWYV"
SCHEMES = {
    "dna": ("ACGT", {}),
    "odd": ("ACGT", dict(match_score=3, mismatch_score=-4, gap_open_score=-5,
                         gap_extension_score=-2)),
    "blosum62": (PROTEIN, dict(scoring_mat_name="BLOSUM62")),
}
UNICODE_MTX = (  # tests/test_torch_batch.py's matrix over non-ASCII letters
    "Ω Ж 字 A -\n"
    "Ω 4 -2 -3 -1 -3\n"
    "Ж -2 5 -1 -3 -3\n"
    "字 -3 -1 4 -2 -3\n"
    "A -1 -3 -2 5 -3\n"
    "- -3 -3 -3 -3 4\n"
)


def _fields(results):
    return [
        (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
        for r in results
    ]


def _bucket(rng, scheme, letters, shapes, M, N):
    """One bucket of ``shapes`` (m, n) padded to (M, N): fill arguments."""
    ta = np.zeros((len(shapes), M + 1), np.int32)
    tb = np.zeros((len(shapes), N + 1), np.int32)
    for b, (m, n) in enumerate(shapes):
        ta[b, 1 : m + 1] = scheme.alphabet.encode("".join(rng.choice(list(letters), m)))
        tb[b, 1 : n + 1] = scheme.alphabet.encode("".join(rng.choice(list(letters), n)))
    return (torch.from_numpy(ta), torch.from_numpy(tb),
            [m for m, _ in shapes], [n for _, n in shapes])


def _ragged_set(name, seed):
    """Four buckets of mixed shapes (m_true / n_true 0 and 1 among them):
    per-bucket arguments and the shared scheme arguments."""
    letters, kw = SCHEMES[name]
    scheme = resolve_scheme(letters, letters, **kw)
    rng = np.random.default_rng(seed)
    buckets = [
        _bucket(rng, scheme, letters, [(30, 31), (1, 32), (32, 1), (17, 20)], 32, 32),
        _bucket(rng, scheme, letters, [(60, 3), (0, 5), (41, 64)], 64, 64),
        _bucket(rng, scheme, letters, [(1, 1)], 1, 1),
        _bucket(rng, scheme, letters, [(5, 96), (96, 70), (33, 0), (80, 90)], 96, 96),
    ]
    cost = torch.from_numpy(np.ascontiguousarray(scheme.costing.values, np.int32))
    return buckets, (cost, scheme.alphabet.gap_id, scheme.gap_open_cost)


def _ragged(buckets, shared, **kw):
    cost, gid, go = shared
    tas, tbs, mts, nts = zip(*buckets)
    return fill_cuda.batch_moves_ragged(tas, tbs, cost, gid, go, mts, nts, **kw)


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_ragged_fill_matches_per_bucket_fills(name):
    """Final lanes identical and each pair's codes — row 0 and column 0
    zero, every real cell — equal to the per-bucket fill's, at the packing's
    offsets and strides: rows of n + 1 bytes rounded up to 16, the bytes
    past column n zero."""
    buckets, shared = _ragged_set(name, len(name))
    filled = _ragged(buckets, shared)
    sizes = [(m + 1) * ((n + 16) // 16 * 16)
             for _, _, mt, nt in buckets for m, n in zip(mt, nt)]
    assert filled.codes.shape == (sum(sizes),)
    k = 0
    for ta, tb, mt, nt in buckets:
        want3, want_mv = fill_cuda.batch_moves(ta, tb, *shared, mt, nt)
        for b, (m, n) in enumerate(zip(mt, nt)):
            row = filled.layout[filled.layout[:, 6] == k][0]
            ld = (n + 16) // 16 * 16
            assert row[2:7].tolist() == [m, n, sum(sizes[:k]), ld, k]
            codes = filled.codes[row[4] : row[4] + sizes[k]].view(m + 1, ld)
            assert torch.equal(filled.final3[k], want3[b])
            assert torch.equal(codes[:, : n + 1], want_mv[b, : m + 1, : n + 1])
            assert not codes[:, n + 1 :].any()
            k += 1


def test_ragged_fill_at_given_offsets_matches_the_packed_fill():
    """Codes placed with gaps and out of pair order give each pair the same
    region as the packing in order; overlapping, outside or unaligned
    regions (offsets not a multiple of 16) raise."""
    buckets, shared = _ragged_set("dna", 3)
    packed = _ragged(buckets, shared)
    m, n = packed.layout[:, 2], packed.layout[:, 3]
    sizes = fill_cuda.ragged_bytes(m, n)
    offsets = np.cumsum(np.concatenate([[16], sizes[::-1][:-1] + 48]))[::-1]
    placed = _ragged(buckets, shared, offsets=offsets, nbytes=int(offsets[0] + sizes[0] + 5))
    assert torch.equal(placed.final3, packed.final3)
    assert placed.layout[:, 4].tolist() == offsets.tolist()
    for a, b, size in zip(placed.layout, packed.layout, sizes.tolist()):
        assert torch.equal(placed.codes[a[4] : a[4] + size],
                           packed.codes[b[4] : b[4] + size])
    overlap = offsets.copy()
    overlap[1] = overlap[0] + 16
    for bad in (dict(offsets=overlap), dict(offsets=offsets, nbytes=int(offsets[0])),
                dict(offsets=offsets[1:]), dict(offsets=offsets + 8)):
        with pytest.raises(ValueError, match="offsets"):
            _ragged(buckets, shared, **bad)


@pytest.mark.parametrize("name", ["dna", "blosum62"])
def test_ragged_walk_matches_per_bucket_walks(name):
    """Tapes, counts and exit columns identical to ``walk_block`` over each
    bucket's codes from (m, n) at the argmin level of its final lanes."""
    buckets, shared = _ragged_set(name, 10 + len(name))
    filled = _ragged(buckets, shared)
    ops, count, j_exit = linear_tb.walk_ragged(filled)
    assert ops.shape == (len(filled.layout), int((filled.layout[:, 2]
                                                  + filled.layout[:, 3]).max()))
    k = 0
    for ta, tb, mt, nt in buckets:
        final3, moves = fill_cuda.batch_moves(ta, tb, *shared, mt, nt)
        w_ops, w_count, w_j, _ = linear_tb.walk_block(
            moves, mt, torch.tensor(nt, dtype=torch.int32),
            final3.argmin(-1).to(torch.int32),
        )
        rows = slice(k, k + len(mt))
        assert torch.equal(count[rows], w_count) and torch.equal(j_exit[rows], w_j)
        for b, c in enumerate(w_count.tolist()):
            assert torch.equal(ops[k + b, :c], w_ops[b, :c])
            assert not ops[k + b, c:].any()
        k += len(mt)


def test_ragged_walk_refuses_a_descriptor_outside_the_fill():
    buckets, shared = _ragged_set("dna", 4)
    filled = _ragged(buckets, shared)
    for word, value in ((4, filled.codes.numel()), (5, 1), (6, len(filled.layout))):
        layout = filled.layout.copy()
        layout[2, word] = value
        with pytest.raises(ValueError, match="descriptor"):
            linear_tb.walk_ragged(filled._replace(layout=layout))


def test_ragged_offsets_are_int64_past_2_31():
    """The packing's offsets in int64: 600 pairs of 1900 x 1900 are 2.17 GB
    of codes, past 2^31 bytes, where int32 offsets (the JAX mega-walk's,
    ROADMAP C1) wrap.  Rows are n + 1 bytes rounded up to 16 (1904 here)
    and every offset is a multiple of 16, past 2^31 too; on the CPU route
    the bytes past column n and in column 0 are zero."""
    m = np.full(600, 1900)
    offsets = fill_cuda.ragged_offsets(m.tolist(), m.astype(np.int32))
    assert offsets.dtype == np.int64
    assert fill_cuda.ragged_stride(1900) == 1904
    assert (fill_cuda.ragged_stride(np.arange(64)) == np.repeat([16, 32, 48, 64], 16)).all()
    assert offsets[-1] == 600 * 1901 * 1904 > 2 ** 31
    assert (np.diff(offsets) == 1901 * 1904).all() and not (offsets % 16).any()
    past = int(np.argmax(offsets > 2 ** 31))
    assert offsets[past] == past * 1901 * 1904
    assert offsets.astype(np.int32)[past] < 0  # what int32 would have held
    buckets, shared = _ragged_set("dna", 6)
    filled = _ragged(buckets, shared)
    for _, _, mk, nk, off, ld, _, _ in filled.layout.tolist():
        assert off % 16 == 0 and ld == fill_cuda.ragged_stride(nk)
        rows = filled.codes[off : off + (mk + 1) * ld].view(mk + 1, ld)
        assert not rows[:, 0].any() and not rows[:, nk + 1 :].any()
        assert not rows[0].any()


def test_ragged_classes():
    """The 1024-pair serving chunk (819-1024 columns) is one class of one
    block a pair on 132 SMs; a call mixing widths gets a class a width,
    each pair in one class, longest first."""
    rng = np.random.default_rng(5)
    m, n = rng.integers(819, 1025, (2, 1024))
    (lp, idx), = fill_cuda.ragged_classes(m, n, 132)
    assert lp == fill_cuda.plan(1024, int(n.max()), True, 132)
    assert lp.bands == 1 and lp.passes == 1 and sorted(idx.tolist()) == list(range(1024))
    assert (np.diff(m[idx] * n[idx]) <= 0).all()
    m = [3, 50, 7, 9, 400, 2, 1]
    n = [90, 40_000, 5000, 130, 129, 1, 0]
    classes = fill_cuda.ragged_classes(m, n, 132)
    assert sorted(k for _, idx in classes for k in idx.tolist()) == list(range(7))
    assert len(classes) > 2
    for lp, idx in classes:
        cells = [m[k] * n[k] for k in idx]
        assert cells == sorted(cells, reverse=True)
        assert lp == fill_cuda.plan(len(idx), max(n[k] for k in idx), True, 132)
    wide = next(lp for lp, idx in classes if 1 in idx.tolist())
    assert wide.passes > 1 and wide.bands > 1


def test_ragged_routes():
    """A traceback call's pairs by kernel: those of at most 1024 columns
    (n = 0 included) to ``gotoh_batch_moves``, one launch a width class (W
    = 4 / 8 / 16 / 32, the narrowest with 32 W >= n), longest first; wider
    pairs, and every pair once the alphabet passes 256 or its table shared
    memory, to ``gotoh_fill``'s ragged classes.  The 1024-pair serving
    chunk is one W = 32 launch and no ``gotoh_fill`` launch."""
    m = [3, 50, 7, 9, 400, 2, 1, 0, 700, 5, 12]
    n = [90, 40_000, 5000, 130, 129, 1, 0, 5, 1024, 1025, 600]
    warp, rest, tile = fill_cuda.ragged_routes(m, n, 20, 132)
    assert tile == []
    assert [(w, idx.tolist()) for w, idx in warp] == [
        (4, [0, 5, 6, 7]), (8, [4, 3]), (32, [8, 10])]
    assert sorted(k for _, idx in rest for k in idx.tolist()) == [1, 2, 9]
    sub = [1, 2, 9]  # the same classes as ragged_classes of those pairs alone
    want = fill_cuda.ragged_classes([m[k] for k in sub], [n[k] for k in sub], 132)
    assert [(lp, idx.tolist()) for lp, idx in rest] == [
        (lp, [sub[k] for k in idx.tolist()]) for lp, idx in want]
    for alphabet in (250, 300):  # past shared memory (4 A^2 bytes), past 256
        warp, rest, _ = fill_cuda.ragged_routes(m, n, alphabet, 132)
        assert not warp
        assert sorted(k for _, idx in rest for k in idx.tolist()) == list(range(11))
    rng = np.random.default_rng(5)
    m, n = rng.integers(819, 1025, (2, 1024))
    (width, idx), = fill_cuda.ragged_routes(m, n, 5, 132)[0]
    assert width == 32 and not fill_cuda.ragged_routes(m, n, 5, 132)[1]
    assert sorted(idx.tolist()) == list(range(1024))
    assert (np.diff(m[idx] * n[idx]) <= 0).all()


@pytest.mark.parametrize("case,clusters,kept", [
    ("lone wave", 11, [11]), ("partial wave", 4, [8]), ("two classes", 2, [2, 10]),
    ("past the aspect", 5, [11]), ("not path-bound", 6, [11]),
])
def test_ragged_routes_give_a_partial_wave_to_gotoh_tile(case, clusters, kept):
    """Given the clusters of each launch the card holds at once, a
    ``gotoh_fill`` class of P pairs over C clusters gives its last P mod C
    pairs, the smallest, to one ``gotoh_tile`` launch a class
    (``fill_tile.route_tail``) when P > C, each of them within 8 columns a
    row, and the launch over them is path-bound; else it keeps them.
    Classes of 11 pairs of 2500 columns (one class at 132 SMs): over 11
    clusters none goes, over 4 three; with a class of 3 pairs of 40 000
    columns over 2 clusters one of each; over 5 none, the smallest 9
    columns a row; 11 genome-sized pairs over 6 none (5 left over are not
    path-bound)."""
    m = [2000 + 90 * k for k in range(11)]
    n = [2500] * 11
    if case == "two classes":
        m += [6000, 6100, 6200]
        n += [40_000] * 3
    if case == "past the aspect":
        m[4] = 300
    if case == "not path-bound":
        m, n = [29_903 + k for k in range(11)], [29_903] * 11
    warp, fill, tile = fill_cuda.ragged_routes(m, n, 5, 132, lambda lp: clusters)
    plain = fill_cuda.ragged_routes(m, n, 5, 132)
    assert warp == plain[0] == [] and plain[2] == []
    assert [lp for lp, _ in fill] == [lp for lp, _ in plain[1]]
    assert [len(idx) for _, idx in fill] == kept
    cells = np.array(m) * np.array(n)
    tails = []
    for (_, idx), (_, whole) in zip(fill, plain[1]):
        assert idx.tolist() == whole[: len(idx)].tolist()  # longest first
        if len(idx) < len(whole):
            assert len(whole) > clusters
            assert len(whole) - len(idx) == len(whole) % clusters
            tails.append(whole[len(idx) :].tolist())
            assert cells[whole[len(idx) :]].max() <= cells[idx].min()
    assert [t.tolist() for t in tile] == tails
    assert len(tile) == {"partial wave": 1, "two classes": 2}.get(case, 0)


def _call_pairs(letters, seed):
    """A call of many buckets (lengths 1-90, quantum 32) and one pair of
    100-128 whose bucket's codes pass those of a 96 x 96 pair."""
    rng = np.random.default_rng(seed)
    pairs = [
        tuple("".join(rng.choice(list(letters), int(rng.integers(1, 91))))
              for _ in range(2))
        for _ in range(15)
    ]
    pairs.insert(6, tuple("".join(rng.choice(list(letters), k)) for k in (120, 105)))
    return pairs


@pytest.mark.parametrize("name", ["dna", "blosum62", "unicode", "dna_wide"])
def test_align_pairs_in_segments_matches_jax(monkeypatch, tmp_path, name):
    """Under a budget lowered to the codes of a 96 x 96 pair the call's
    traceback buckets run in three or more segments (one ragged fill and
    one ragged walk each) and the 120 x 105 pair, past it, takes the
    blocked route: strings, cost and score equal the JAX package's (native
    layer off for the non-ASCII matrix, whose UTF-8 it misreads: ROADMAP
    C5).  ``dna_wide`` adds pairs of 1030 and 1024 columns, on both sides
    of ``gotoh_batch_moves``' cap, under a budget of the wide bucket's pair
    (nothing blocked): a segment then routes pairs to both kernels."""
    wide = name == "dna_wide"
    if wide:
        name = "dna"
    if name == "unicode":
        from globalign_tpu.utils import native

        monkeypatch.setattr(native, "load", lambda: None)
        mtx = tmp_path / "unicode.mtx"
        mtx.write_text(UNICODE_MTX, encoding="utf-8")
        letters, kw = "ΩЖ字A", dict(scoring_mat_path=mtx)
    else:
        letters, kw = SCHEMES[name]
    pairs = _call_pairs(letters, len(name))
    budget = fill_cuda.ragged_bytes(96, 96)  # the largest bucket's pair
    if wide:
        rng = np.random.default_rng(1030)
        for k, (m, n) in ((3, (20, 1030)), (9, (25, 1024))):
            pairs.insert(k, tuple("".join(rng.choice(list(letters), x))
                                  for x in (m, n)))
        budget = fill_cuda.ragged_bytes(32, bucket_length(1030))
    want = jax_align_pairs(pairs, with_traceback=True, **kw)
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", budget)
    fills = []
    real = fill_cuda.batch_moves_ragged

    def counted(*args, **kwargs):
        fills.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(fill_cuda, "batch_moves_ragged", counted)
    got = align_pairs(pairs, with_traceback=True, device="cpu", **kw)
    assert _fields(got) == _fields(want)
    buckets = {(bucket_length(len(a)), bucket_length(len(b))) for a, b in pairs}
    filled = sum(t.shape[0] for f in fills for t in f[0])
    assert len(fills) >= 3 and len(buckets) > len(fills)
    assert filled == len(pairs) - (not wide)
    routes = [fill_cuda.ragged_routes(np.concatenate(f[5]), np.concatenate(f[6]),
                                      f[2].shape[0], 132) for f in fills]
    assert any(warp and rest for warp, rest, _ in routes) == wide
    for f in fills:  # each segment's codes fit the budget
        assert sum(fill_cuda.ragged_bytes(m, n) for mt, nt in zip(f[5], f[6])
                   for m, n in zip(mt, nt)) <= budget
