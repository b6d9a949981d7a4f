"""The single-pair ``align``'s walk route held against the JAX package, on
the CPU.

Under the moves budget ``GotohAligner.align`` fills the codes, walks them
where they lie (``linear_tb.walk_block``: the walk kernel on a card, its
plain version on CPU tensors), fetches final3 and the op tape in one copy
and renders the tape (``linear_tb.render_walk``).  Here the CPU route runs
that path and is held against the JAX package's ``align`` and
``find_global_alignment`` (the row scan and its host walk), on seeded pairs
of at most 64 x 64: the DNA default, BLOSUM62, zero gap-open scoring (ties
between levels), a custom matrix over non-ASCII letters (with the JAX
native layer off, ROADMAP C5), and m or n of 0 and 1.  Tolerance 0:
strings, cost, score and report bytes.
"""

import numpy as np
import pytest

import globalign_tpu as jga
import globalign_tpu_torch as tga
from globalign_tpu.models.gotoh import GotohAligner as JaxAligner
from globalign_tpu_torch.models import gotoh
from globalign_tpu_torch.models.gotoh import GotohAligner
from globalign_tpu_torch.ops import fill_cuda, linear_tb, traceback

PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
SCHEMES = {
    "dna": ("ACGT", {}),
    "blosum62": (PROTEIN, dict(scoring_mat_name="BLOSUM62")),
    # a free gap open: opening and extending cost alike, so levels tie
    "zero_gap_open": ("ACG", dict(match_score=2, mismatch_score=-1,
                                  gap_open_score=0, gap_extension_score=-1)),
}
# (m, n): the edges of the walk (no row or no column to walk, one of
# either) and seeded pairs up to 64 x 64
SHAPES = [(0, 5), (7, 0), (1, 1), (1, 9), (9, 1), (1, 64), (64, 1),
          (23, 31), (64, 64), (50, 17)]
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


def _pair(seed, letters, m, n):
    rng = np.random.default_rng(seed)
    s1 = "".join(rng.choice(list(letters), m))
    # seq_2 shares seq_1's start, so the walk mixes matches and gaps
    s2 = (s1[: n // 2] + "".join(rng.choice(list(letters), n)))[:n]
    return s1, s2


def _fields(r):
    return (r.seq_1_aligned, r.middle_part, r.seq_2_aligned, r.cost, r.score)


def _schemes(letters, kw):
    both = dict(seq_1=letters, seq_2=letters, **kw)
    return (tga.resolve_scheme(letters, letters, **kw),
            jga.validate_and_transform_args(**both).scheme)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_align_matches_jax(scheme, shape):
    letters, kw = SCHEMES[scheme]
    s1, s2 = _pair(sum(shape) + len(scheme), letters, *shape)
    ts, js = _schemes(letters, kw)
    got = GotohAligner(ts, device="cpu").align(s1, s2)
    want = JaxAligner(js).align(s1, s2)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("shape", [s for s in SHAPES if min(s) > 0],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_report_matches_jax(scheme, shape, tmp_path):
    letters, kw = SCHEMES[scheme]
    s1, s2 = _pair(7 * sum(shape) + len(scheme), letters, *shape)
    got = tga.find_global_alignment(seq_1=s1, seq_2=s2, device="cpu", **kw)
    want = jga.find_global_alignment(seq_1=s1, seq_2=s2, **kw)
    assert tuple(got) == tuple(want) and str(got) == str(want)
    got.write(file=tmp_path / "port.txt")
    want.write(file=tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (
        tmp_path / "jax.txt").read_bytes()


@pytest.fixture
def jax_without_native(monkeypatch):
    """The JAX package with its C++ host layer off (``native.load`` gives
    None): its pure-Python walk and render, which handle any letter."""
    from globalign_tpu.utils import native

    monkeypatch.setattr(native, "load", lambda: None)


@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (40, 1), (33, 60),
                                   (64, 64)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_non_ascii_report_matches_jax_without_native(
    shape, jax_without_native, tmp_path
):
    mtx = tmp_path / "unicode.mtx"
    mtx.write_text(UNICODE_MTX, encoding="utf-8")
    s1, s2 = _pair(sum(shape), UNICODE_LETTERS, *shape)
    got = tga.find_global_alignment(seq_1=s1, seq_2=s2, scoring_mat_path=mtx,
                                    device="cpu")
    want = jga.find_global_alignment(seq_1=s1, seq_2=s2, scoring_mat_path=mtx)
    assert tuple(got) == tuple(want) and str(got) == str(want)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("shape", [(0, 5), (1, 1), (40, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_align_walks_once_and_never_on_the_host(monkeypatch, shape):
    """One fill and one ``walk_block`` call a pair; the host walk over the
    code matrix (``traceback_moves``) is neither imported by the model nor
    called through its module."""
    s1, s2 = _pair(3, "ACGT", *shape)
    want = GotohAligner(tga.resolve_scheme("ACGT", "ACGT"), device="cpu")
    want = want.align(s1, s2)
    assert not hasattr(gotoh, "traceback_moves")

    def host_walk(*args, **kwargs):
        raise AssertionError("align walked the codes on the host")

    monkeypatch.setattr(traceback, "traceback_moves", host_walk)
    fills = _count_calls(monkeypatch, fill_cuda, "batch_moves")
    walks = _count_calls(monkeypatch, linear_tb, "walk_block")
    blocked = _count_calls(monkeypatch, linear_tb, "align_blocked")
    got = GotohAligner(tga.resolve_scheme("ACGT", "ACGT"), device="cpu")
    got = got.align(s1, s2)
    assert _fields(got) == _fields(want)
    assert (len(fills), len(walks), len(blocked)) == (1, 1, 0)
    assert walks[0][1] == [shape[0]]  # from row m


def test_align_equals_the_host_walk_over_its_codes():
    """The walk route against ``traceback_moves`` over the same codes (the
    oracle ``tests/test_torch_cuda.py`` uses on the card)."""
    for seed, (letters, kw) in enumerate(SCHEMES.values()):
        s1, s2 = _pair(seed, letters, 60, 47)
        aligner = GotohAligner(tga.resolve_scheme(letters, letters, **kw),
                               device="cpu")
        final3, moves = aligner._batch_fill(s1, s2, want_moves=True)
        want = traceback.traceback_moves(moves[0].numpy(), s1, s2,
                                         final3[0].numpy())
        got = aligner.align(s1, s2)
        assert _fields(got)[:4] == tuple(want)
