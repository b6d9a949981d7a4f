"""A batch call's letters on the device — the packed upload, tokenize and
render — on the CPU.

``ops.packed``'s plain versions (``tokenize_plain``, ``render_plain``,
reached through the wrappers on CPU tensors) over the descriptors
``pack_call`` builds, against the JAX package's ``encode_padded`` and
``assemble_from_tapes`` (the reference's render, walk-order tapes with the
row-0 left moves implicit) and the port's numpy route (``_encode_bucket``,
``linear_tb.render_many``); and ``align_pairs(device="cpu")``, which runs
the same descriptors, against the JAX package's ``align_pairs``.

Tolerance 0: tokens are integers, alignments strings.
"""

import numpy as np
import pytest
import torch

from globalign_tpu import align_pairs as jax_align_pairs
from globalign_tpu.ops.linear_tb import assemble_from_tapes
from globalign_tpu.utils.tokenize import Alphabet as JaxAlphabet
from globalign_tpu.utils.tokenize import encode_padded as jax_encode_padded
from globalign_tpu_torch import align_pairs, resolve_scheme
from globalign_tpu_torch import batch as batch_mod
from globalign_tpu_torch.batch import bucket_length
from globalign_tpu_torch.ops import fill_cuda, linear_tb, packed
from globalign_tpu_torch.utils.tokenize import Alphabet

PROTEIN = "ARNDCQEGHILKMFPSTWYV"
UNICODE_LETTERS = "ΩЖ字A"
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


def _seqs(rng, letters, lengths):
    return ["".join(rng.choice(list(letters), k)) for k in lengths]


def _buckets(pairs, quantum=32):
    """align_pairs' buckets of ``pairs``: (seqs_1, seqs_2, M, N) in order."""
    out = {}
    for a, b in pairs:
        key = (bucket_length(len(a), quantum), bucket_length(len(b), quantum))
        out.setdefault(key, ([], []))
        out[key][0].append(a)
        out[key][1].append(b)
    return [(s1, s2, m, n) for (m, n), (s1, s2) in out.items()]


@pytest.fixture
def unicode_mtx(tmp_path):
    path = tmp_path / "unicode.mtx"
    path.write_text(UNICODE_MTX, encoding="utf-8")
    return path


# -- tokenize ---------------------------------------------------------------

@pytest.mark.parametrize("letters,lengths", [
    ("ACGT", [1, 5, 31, 32, 33, 64, 2, 90]),
    (PROTEIN, [1, 17, 40, 96, 3]),
    (UNICODE_LETTERS, [1, 9, 33, 2, 64]),  # code points, the linear search
    ("ACGT" + UNICODE_LETTERS, [4, 1, 70]),  # ASCII letters among code points
])
def test_tokenize_plain_matches_encode_padded(letters, lengths):
    """Every bucket row of the arena = the JAX package's ``encode_padded``
    and the port's per-bucket ``_encode_bucket``: tokens at 1..m, column 0
    and the padding 0, m and n of 1 and rows at the bucket edges."""
    rng = np.random.default_rng(len(lengths))
    seqs_1 = _seqs(rng, letters, lengths)
    seqs_2 = _seqs(rng, letters, lengths[::-1])
    pairs = list(zip(seqs_1, seqs_2))
    alphabet = Alphabet.from_sequences(letters)
    jax_alphabet = JaxAlphabet.from_sequences(letters)
    buckets = _buckets(pairs)
    call = packed.pack_call(alphabet, buckets, with_render=False)
    assert call.wide == (not letters.isascii())
    call.upload(torch.device("cpu"))
    before = packed.tokenize_ragged.launches
    call.tokenize()
    assert packed.tokenize_ragged.launches == before  # no kernel on the CPU
    for k, (s1s, s2s, m_pad, n_pad) in enumerate(buckets):
        tok_a, tok_b = call.bucket(k)
        assert tok_a.is_contiguous() and tok_b.is_contiguous()
        for got, seqs, pad in ((tok_a, s1s, m_pad), (tok_b, s2s, n_pad)):
            want = np.stack([jax_encode_padded(jax_alphabet, s, pad) for s in seqs])
            assert (got.numpy() == want).all()
            assert (got.numpy() == batch_mod._encode_bucket(alphabet, seqs, pad)).all()


def test_pack_call_offsets_and_upload_layout():
    """int64 descriptors: letters offsets a prefix sum over seq_1s then
    seq_2s, slots on 256-byte boundaries, rows of width padded + 1; the
    render descriptor a pair, and a lines row of sum(m + n) letters."""
    pairs = [("ACG", "A"), ("T", "GGGG"), ("ACGTACGT" * 5, "CC")]
    buckets = _buckets(pairs)
    call = packed.pack_call(Alphabet.from_sequences("ACGT"), buckets,
                            with_render=True)
    call.upload(torch.device("cpu"))
    desc = call.token_desc.numpy()
    assert call.token_desc.dtype == torch.int64 and desc.shape == (6, 4)
    order_1 = [s for b in buckets for s in b[0]]
    order_2 = [s for b in buckets for s in b[1]]
    lengths = [len(s) for s in order_1 + order_2]
    assert desc[:, 1].tolist() == lengths
    assert desc[:, 0].tolist() == np.r_[0, np.cumsum(lengths)[:-1]].tolist()
    assert (desc[:, 2] * 4 % packed.ALIGN == 0).sum() >= len(buckets)
    assert call.render_desc.numpy().tolist() == [
        [desc[k, 0], desc[len(order_1) + k, 0]] for k in range(len(order_1))
    ]
    assert call.line_cap == sum(lengths)
    assert call.lines().shape == (3, sum(lengths))
    text = "".join(order_1 + order_2).encode()
    assert call.letters.numpy().tobytes() == text


@pytest.mark.parametrize("letters", ["ACGT", UNICODE_LETTERS])
def test_pack_call_refuses_an_unknown_letter(letters):
    """A letter outside the alphabet raises ``Alphabet.encode``'s error,
    before anything is packed, for the first sequence that holds one."""
    alphabet = Alphabet.from_sequences(letters)
    bad = "N" if letters.isascii() else "Ж" if "Ж" not in letters else "Ψ"
    buckets = [([letters[0] * 3, letters[1] + bad], [letters[0]] * 2, 32, 32)]
    with pytest.raises(ValueError) as err:
        packed.pack_call(alphabet, buckets, with_render=True)
    with pytest.raises(ValueError) as want:
        alphabet.encode(letters[1] + bad)
    assert str(err.value) == str(want.value) and f"{bad!r} not present" in str(err.value)


def test_wrappers_refuse_other_devices_and_bad_arguments():
    meta = torch.device("meta")
    letters = torch.zeros(4, dtype=torch.uint8, device=meta)
    table = torch.zeros(256, dtype=torch.int32, device=meta)
    desc = torch.zeros((1, 4), dtype=torch.int64, device=meta)
    arena = torch.zeros(8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no tokenize_ragged route"):
        packed.tokenize_ragged(letters, table, desc, arena)
    with pytest.raises(ValueError, match="table must be"):
        packed.tokenize_ragged(letters, table[:5], desc, arena)
    with pytest.raises(ValueError, match="desc must be"):
        packed.tokenize_ragged(letters, table, desc[:, :3], arena)
    ops = torch.zeros((1, 4), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="lines must be"):
        packed.render_ragged(ops, one, one, torch.zeros(4, dtype=torch.uint8),
                             torch.zeros((1, 2), dtype=torch.int64),
                             torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous on cpu"):
        packed.render_ragged(ops, one, one, torch.zeros(4, dtype=torch.uint8),
                             torch.zeros((1, 2), dtype=torch.int64),
                             torch.zeros((3, 4), dtype=torch.uint8, device=meta))


# -- render -----------------------------------------------------------------

def _walk_tape(rng, m, n, j_exit, ones=None):
    """A walk-order tape from (m, n) to row 0 at column ``j_exit``: m
    letters of seq_1 and n - j_exit of seq_2 consumed, in a random order."""
    diag = int(rng.integers(0, min(m, n - j_exit) + 1)) if ones is None else ones
    ops = ([linear_tb.OP_DIAG] * diag + [linear_tb.OP_UP] * (m - diag)
           + [linear_tb.OP_LEFT] * (n - j_exit - diag))
    return np.array(rng.permutation(ops), np.uint8)


RENDER_CASES = {  # (m, n, j_exit) a pair
    "j_exit": [(5, 9, 3), (1, 7, 6), (12, 12, 0), (3, 40, 20)],
    "one op": [(1, 1, 0), (1, 0, 0), (0, 1, 0), (0, 1, 1)],
    "m or n of 1": [(1, 33, 0), (33, 1, 0), (1, 1, 1), (2, 1, 0)],
    "all gaps": [(0, 7, 0), (0, 7, 7), (9, 0, 0), (4, 4, 4)],
}


@pytest.mark.parametrize("letters", ["ACGT", UNICODE_LETTERS])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_plain_matches_assemble_from_tapes(case, letters):
    """``render_ragged`` on CPU tensors (``render_plain``) = the JAX
    package's ``assemble_from_tapes`` over each walk tape, and = the numpy
    route (``render_many`` over the reversed tapes with the row-0 left moves
    in front): row-0 exits, tapes of one op, m or n of 1, all-gap lines."""
    rng = np.random.default_rng(sorted(RENDER_CASES).index(case))
    shapes = RENDER_CASES[case]
    pairs = [tuple(_seqs(rng, letters, [m, n])) for m, n, _ in shapes]
    tapes = [_walk_tape(rng, m, n, e) for m, n, e in shapes]
    width = max(len(t) for t in tapes) + 3
    ops = np.zeros((len(tapes), width), np.uint8)
    for k, tape in enumerate(tapes):
        ops[k, : len(tape)] = tape
    call = packed.pack_call(Alphabet.from_sequences(letters),
                            [([a for a, _ in pairs], [b for _, b in pairs], 64, 64)],
                            with_render=True)
    call.upload(torch.device("cpu"))
    lines = call.lines()
    count = torch.tensor([len(t) for t in tapes], dtype=torch.int32)
    j_exit = torch.tensor([e for _, _, e in shapes], dtype=torch.int32)
    before = packed.render_ragged.launches
    ends = packed.render_ragged(torch.from_numpy(ops), count, j_exit, call.letters,
                                call.render_desc, lines)
    assert packed.render_ragged.launches == before
    assert ends.dtype == torch.int64
    assert ends.tolist() == np.cumsum([len(t) + e for t, (_, _, e)
                                       in zip(tapes, shapes)]).tolist()
    got = packed.decode_lines(lines.numpy(), ends.numpy(), call.wide)
    want = [assemble_from_tapes([t], a, b) for t, (a, b) in zip(tapes, pairs)]
    assert got == want
    fwd = [np.r_[np.full(e, linear_tb.OP_LEFT, np.uint8), t[::-1]]
           for t, (_, _, e) in zip(tapes, shapes)]
    assert got == linear_tb.render_many(fwd, *zip(*pairs))


def test_render_places_lines_after_a_base():
    """With ``base`` (the previous segment's last end) every start moves by
    it: two halves rendered in turn fill the buffer as one call does."""
    rng = np.random.default_rng(7)
    shapes = [(30, 20, 0), (8, 15, 4), (1, 1, 0), (16, 40, 9)]
    pairs = [tuple(_seqs(rng, "ACGT", [m, n])) for m, n, _ in shapes]
    tapes = [_walk_tape(rng, m, n, e) for m, n, e in shapes]
    ops = np.zeros((4, 70), np.uint8)
    for k, t in enumerate(tapes):
        ops[k, : len(t)] = t
    call = packed.pack_call(Alphabet.from_sequences("ACGT"),
                            [([a for a, _ in pairs], [b for _, b in pairs], 64, 64)],
                            with_render=True)
    call.upload(torch.device("cpu"))
    args = (torch.from_numpy(ops), torch.tensor([len(t) for t in tapes], dtype=torch.int32),
            torch.tensor([e for *_, e in shapes], dtype=torch.int32))
    whole = call.lines()
    ends = packed.render_ragged(*args, call.letters, call.render_desc, whole)
    halves = torch.full_like(whole, 0)
    first = packed.render_ragged(*(a[:2] for a in args), call.letters,
                                 call.render_desc[:2], halves)
    second = packed.render_ragged(*(a[2:] for a in args), call.letters,
                                  call.render_desc[2:], halves, first[-1:])
    assert torch.cat([first, second]).tolist() == ends.tolist()
    total = int(ends[-1])
    assert torch.equal(halves[:, :total], whole[:, :total])


# -- align_pairs ------------------------------------------------------------

def _case_pairs(name, rng):
    if name == "lowercase":  # upper-cased by validation, as in JAX
        return [(a.lower(), b) for a, b in _pairs_of(rng, "ACGT", 10)] + [
            ("gaßt", "GASST"), ("ß", "s")]  # "ß".upper() == "SS"
    letters = {"dna": "ACGT", "blosum62": PROTEIN, "unicode": UNICODE_LETTERS}[name]
    return _pairs_of(rng, letters, 12)


def _pairs_of(rng, letters, count):
    """Pairs of 1-90 letters and the 1 x n and m x 1 edges."""
    pairs = [tuple(_seqs(rng, letters, rng.integers(1, 91, 2))) for _ in range(count)]
    pairs += [tuple(_seqs(rng, letters, [1, 40])), tuple(_seqs(rng, letters, [37, 1])),
              tuple(_seqs(rng, letters, [1, 1]))]
    return pairs


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("name", ["dna", "blosum62", "unicode", "lowercase"])
def test_align_pairs_on_packed_letters_matches_jax(monkeypatch, unicode_mtx, name,
                                                   with_traceback):
    """``align_pairs(device="cpu")``, through one pack, one tokenize and a
    render a segment, = the JAX package's ``align_pairs``: costs, scores
    and strings (the JAX native layer off for the non-ASCII matrix, whose
    UTF-8 it misreads: ROADMAP C5)."""
    kw = {"blosum62": dict(scoring_mat_name="BLOSUM62"),
          "unicode": dict(scoring_mat_path=unicode_mtx)}.get(name, {})
    if name == "unicode":
        from globalign_tpu.utils import native

        monkeypatch.setattr(native, "load", lambda: None)
    pairs = _case_pairs(name, np.random.default_rng(len(name) + with_traceback))
    calls = {"pack": 0, "tokenize": 0, "render": 0}
    for mod, fn, key in ((packed, "pack_call", "pack"),
                         (packed, "tokenize_ragged", "tokenize"),
                         (packed, "render_ragged", "render")):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn, counted)
    phases = {}
    got = align_pairs(pairs, with_traceback=with_traceback, device="cpu",
                      phase_seconds=phases, **kw)
    want = jax_align_pairs(pairs, with_traceback=with_traceback, **kw)
    assert _fields(got) == _fields(want)
    assert calls == {"pack": 1, "tokenize": 1, "render": int(with_traceback)}
    assert "pack" in phases and "encode" not in phases
    assert {"validate", "scheme", "bucket", "fill", "fetch", "results"} <= set(phases)
    assert ("render" in phases) == ("traceback" in phases) == with_traceback


@pytest.mark.parametrize("blocked", [False, True])
def test_align_pairs_renders_each_segment(monkeypatch, blocked):
    """Under a lowered budget the traceback buckets run in several
    segments, each rendered by its own launch into the call's one lines
    buffer after the segments before; with ``blocked`` a pair past the
    budget takes the blocked route beside them.  = the JAX package."""
    rng = np.random.default_rng(61 + blocked)
    pairs = _pairs_of(rng, "ACGT", 14)
    if blocked:
        pairs.insert(4, tuple(_seqs(rng, "ACGT", [120, 105])))
    want = jax_align_pairs(pairs, with_traceback=True)
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET",
                        fill_cuda.ragged_bytes(96, 96))
    fills, renders = [], []
    for mod, name, log in ((fill_cuda, "batch_moves_ragged", fills),
                           (packed, "render_ragged", renders)):
        real = getattr(mod, name)

        def counted(*a, _real=real, _log=log, **k):
            out = _real(*a, **k)
            _log.append((a, out))
            return out

        monkeypatch.setattr(mod, name, counted)
    got = align_pairs(pairs, with_traceback=True, device="cpu")
    assert _fields(got) == _fields(want)
    assert len(fills) >= 3 and len(renders) == len(fills)
    # each render continues the lines where the segment before ended
    for (args, _), (_, prev) in zip(renders[1:], renders[:-1]):
        assert int(args[6][0]) == int(prev[-1])
    assert sum(a[0].shape[0] for a, _ in renders) == len(pairs) - blocked


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("bad", ["N", "Ж"])
def test_align_pairs_unknown_letter_raises_as_jax(with_traceback, bad):
    """A pre-resolved scheme and a letter outside it: the JAX package's
    exception, type and message, raised before any fill."""
    scheme = resolve_scheme("ACGT", "ACGT")
    from globalign_tpu import resolve_scheme as jax_resolve_scheme

    jax_scheme = jax_resolve_scheme("ACGT", "ACGT")
    pairs = [("ACGT", "AGT"), ("GATTACA", "GA" + bad + "TACA"), ("A", "T")]
    with pytest.raises(Exception) as want:
        jax_align_pairs(pairs, scheme=jax_scheme, with_traceback=with_traceback)
    with pytest.raises(Exception) as got:
        align_pairs(pairs, scheme=scheme, with_traceback=with_traceback,
                    device="cpu")
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_align_pairs_flush_false_renders_before_resolve(monkeypatch):
    """``flush=False``: the renders are queued in the call, the fetch and
    the strings wait for ``resolve()``."""
    rng = np.random.default_rng(67)
    pairs = _pairs_of(rng, "ACGT", 8)
    renders = []
    real = packed.render_ragged
    monkeypatch.setattr(packed, "render_ragged",
                        lambda *a, **k: renders.append(1) or real(*a, **k))
    phases = {}
    pending = align_pairs(pairs, device="cpu", flush=False, phase_seconds=phases)
    assert renders == [1] and "fetch" not in phases and "traceback" not in phases
    assert _fields(pending.resolve()) == _fields(align_pairs(pairs, device="cpu"))
