"""The port's single-pair path held against the JAX package, on the CPU.

``globalign_tpu_torch.find_global_alignment(..., device="cpu")`` and the
port's CLI (``--device cpu``) against ``globalign_tpu``'s on the CPU (its
row scan): alignment strings, cost, score and report bytes identical on the
reference goldens and on seeded random pairs under every scheme kind;
validation errors raised alike.  Tolerance 0 throughout.
"""

import os

import numpy as np
import pytest
import torch

import globalign_tpu as jga
import globalign_tpu_torch as tga
from globalign_tpu.cli import main as jax_cli
from globalign_tpu.models.gotoh import GotohAligner as JaxAligner
from globalign_tpu_torch.cli import main as torch_cli
from globalign_tpu_torch.models import gotoh as torch_gotoh

GOLDEN_E2E = [  # tests/test_conformance.py:19-31
    ("TT", "TA", 3, -4, -5, -2, -1, 7),
    ("TAAAGCTAA", "TAGCTC", 2, -3, -5, -2, -9, 24),
    ("TGGATGAGGCTCCACGCACTAA", "GATTGGTGAGGCTCAGCAT", 2, -3, -5, -2, -15, 56),
    ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA", 2, -3, -5, -2, -21, 62),
    ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA", 4, -5, -3, -5, -20, 102),
    ("GTAGGCGGTC", "CAGCTGC", 1, -2, -5, -2, -18, 28),
    ("CTGTACCG", "CGGAACAGTCCGAT", 1, -2, -5, -2, -18, 26),
    ("GGAGGACGTT", "GAG", 1, -2, -5, -2, -21, 31),
    ("GGAGGACGTT", "GAG", "1", "-2", "-5", "-2", -21, 31),
]

PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
CUSTOM_MTX = (
    "# an asymmetric-gap custom scoring matrix\n"
    "A C G T -\n"
    "A 5 -4 -2 -4 -3\n"
    "C -4 5 -4 -2 -3\n"
    "G -2 -4 5 -4 -3\n"
    "T -4 -2 -4 5 -3\n"
    "- -3 -3 -3 -3 5\n"
)


def _both(**kwargs):
    want = jga.find_global_alignment(**kwargs)
    got = tga.find_global_alignment(**kwargs, device="cpu")
    return got, want


def _assert_same(got, want):
    assert tuple(got) == tuple(want)
    assert str(got) == str(want)


@pytest.mark.parametrize(
    "seq_1,seq_2,match,mismatch,gap_open,gap_ext,exp_score,exp_cost", GOLDEN_E2E
)
def test_conformance_goldens_match_jax(
    seq_1, seq_2, match, mismatch, gap_open, gap_ext, exp_score, exp_cost
):
    got, want = _both(
        seq_1=seq_1,
        seq_2=seq_2,
        match_score=match,
        mismatch_score=mismatch,
        gap_open_score=gap_open,
        gap_extension_score=gap_ext,
    )
    assert (got.score, got.cost) == (exp_score, exp_cost)
    _assert_same(got, want)


def test_tutorial_golden():
    got, want = _both(seq_1="ACGT", seq_2="AGT")
    assert (got.score, got.cost) == (0, 7)
    assert (got.seq_1_aligned, got.middle_part, got.seq_2_aligned) == (
        "ACGT", "| ||", "A-GT",
    )
    _assert_same(got, want)


def _pairs(seed, letters, count, lo, hi):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        m, n = (int(x) for x in rng.integers(lo, hi, 2))
        out.append((
            "".join(rng.choice(list(letters), m)),
            "".join(rng.choice(list(letters), n)),
        ))
    return out


@pytest.mark.parametrize(
    "kind",
    ["simple_scores", "simple_costs", "BLOSUM50", "BLOSUM62", "custom_file"],
)
def test_random_pairs_match_jax(kind, tmp_path):
    """Seeded random pairs: strings, cost, score and the bytes that
    ``AlignmentResults.write`` puts in a file are identical."""
    letters = PROTEIN if kind.startswith("BLOSUM") else "ACGT"
    opts = {
        "simple_scores": dict(match_score=3, mismatch_score=-2,
                              gap_open_score=-5, gap_extension_score=-1),
        "simple_costs": dict(mismatch_cost=4, gap_open_cost=2,
                             gap_extension_cost=3),
        "BLOSUM50": dict(scoring_mat_name="BLOSUM50"),
        "BLOSUM62": dict(scoring_mat_name="BLOSUM62", gap_open_cost=6),
        "custom_file": dict(scoring_mat_path=tmp_path / "custom.mtx"),
    }[kind]
    (tmp_path / "custom.mtx").write_text(CUSTOM_MTX)
    for k, (s1, s2) in enumerate(_pairs(len(kind), letters, 3, 1, 90)):
        got, want = _both(seq_1=s1, seq_2=s2, **opts)
        _assert_same(got, want)
        got.write(file=tmp_path / f"port{k}.txt")
        want.write(file=tmp_path / f"jax{k}.txt")
        assert (tmp_path / f"port{k}.txt").read_bytes() == (
            tmp_path / f"jax{k}.txt"
        ).read_bytes()


@pytest.mark.parametrize(
    "argv",
    [
        ["--seq_1", "ACGT", "--seq_2", "AGT"],
        ["--seq_1", "GATTACAGATTACA", "--seq_2", "GCATGCTAC",
         "--mismatch_cost", "4", "--gap_open_cost", "1"],
        ["--seq_1", "MKVLAAGIVW", "--seq_2", "MKVAGIW",
         "--scoring_mat_name", "BLOSUM62"],
        ["-i", "{fasta}"],
    ],
)
def test_cli_output_bytes_match_jax(argv, tmp_path, capsys):
    fasta = tmp_path / "pair.fa"
    fasta.write_text(">one\nacgtacggt\nacg\n>two\nAGTTACG\n")
    argv = [a.replace("{fasta}", str(fasta)) for a in argv]
    assert jax_cli([*argv, "--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert torch_cli([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and "score:" in got

    assert jax_cli([*argv, "--platform", "cpu", "-o", str(tmp_path / "j")]) == 0
    assert torch_cli([*argv, "--device", "cpu", "-o", str(tmp_path / "t")]) == 0
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_cli_has_device_not_platform():
    from globalign_tpu_torch.cli import build_parser

    parser = build_parser()
    opts = {a.dest: a for a in parser._actions}
    assert "platform" not in opts
    assert opts["device"].default == "cuda"
    assert opts["device"].choices == ["cuda", "cpu"]
    with pytest.raises(SystemExit):
        parser.parse_args(["--device", "tpu"])


BAD_ARGS = [
    dict(seq_1="AC"),
    dict(seq_2="AC"),
    dict(),
    dict(seq_1="AC-T", seq_2="ACGT"),
    dict(seq_1="", seq_2="ACGT"),
    dict(seq_1="ACGT", seq_2="AGT", max_seq_len_prod=10),
    dict(seq_1="ACGT", seq_2="AGT", scoring_mat_name="BLOSUM62", match_score=2),
    dict(seq_1="ACGT", seq_2="AGT", match_score=2, mismatch_cost=5),
    dict(seq_1="ACGT", seq_2="AGT", gap_open_score=-4, gap_open_cost=4),
    dict(seq_1="ACGT", seq_2="AGT", match_score=-1),
    dict(seq_1="ACGT", seq_2="AGT", mismatch_cost=0),
    dict(seq_1="ACGT", seq_2="AGT", gap_extension_score="x"),
    dict(seq_1="MKV1", seq_2="MKV", scoring_mat_name="BLOSUM62"),
    dict(seq_1="ACGT", seq_2="AGT", scoring_mat_name="PAM250"),
    dict(input_fasta="/nonexistent/file.fa"),
]


@pytest.mark.parametrize("kwargs", BAD_ARGS)
def test_validation_errors_raised_alike(kwargs):
    with pytest.raises(Exception) as want:
        jga.find_global_alignment(**kwargs)
    with pytest.raises(Exception) as got:
        tga.find_global_alignment(**kwargs, device="cpu")
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_custom_matrix_and_output_errors_alike(tmp_path):
    asym = tmp_path / "asym.mtx"
    asym.write_text("A C -\nA 2 -1 -2\nC -3 2 -2\n- -2 -2 2\n")
    existing = tmp_path / "exists.txt"
    existing.write_text("x")
    for kwargs in (
        dict(seq_1="AC", seq_2="CA", scoring_mat_path=asym),
        dict(seq_1="AC", seq_2="CA", output=existing),
        dict(seq_1="AC", seq_2="CA", output=tmp_path / "no" / "out.txt"),
    ):
        with pytest.raises(Exception) as want:
            jga.find_global_alignment(**kwargs)
        with pytest.raises(Exception) as got:
            tga.find_global_alignment(**kwargs, device="cpu")
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(mismatch_cost=7, gap_open_cost=0, gap_extension_cost=1),
        dict(scoring_mat_name="BLOSUM62", gap_open_score=-11),
    ],
)
def test_scheme_from_arrays_round_trips_the_jax_scheme(kwargs):
    s1, s2 = "MKVLAAGW", "MKVAGW"
    js = jga.resolve_scheme(s1, s2, **kwargs)
    ts = tga.scheme_from_arrays(
        js.alphabet.letters,
        js.scoring.values,
        js.costing.values,
        js.gap_open_score,
        js.gap_open_cost,
        js.max_score,
    )
    direct = tga.resolve_scheme(s1, s2, **kwargs)
    for s in (ts, direct):
        assert s.alphabet.letters == js.alphabet.letters
        assert s.alphabet.gap_id == js.alphabet.gap_id
        assert (s.scoring.values == js.scoring.values).all()
        assert (s.costing.values == js.costing.values).all()
        assert s.scoring.values.dtype == np.int32
        assert (s.gap_open_score, s.gap_open_cost, s.max_score) == (
            js.gap_open_score, js.gap_open_cost, js.max_score,
        )
        assert s.deltas == js.deltas
    # The same scheme drives both aligners to the same answer.
    got = tga.GotohAligner(ts, device="cpu").align(s1, s2)
    want = JaxAligner(js).align(s1, s2)
    assert (got.seq_1_aligned, got.middle_part, got.seq_2_aligned,
            got.cost, got.score) == (want.seq_1_aligned, want.middle_part,
                                     want.seq_2_aligned, want.cost, want.score)


def test_aligner_cost_and_planes_match_jax():
    rng = np.random.default_rng(77)
    for _ in range(3):
        s1 = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 50))))
        s2 = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 50))))
        js = jga.resolve_scheme(s1, s2, gap_open_cost=3)
        ts = tga.resolve_scheme(s1, s2, gap_open_cost=3)
        port = tga.GotohAligner(ts, device="cpu")
        ref = JaxAligner(js)
        assert port.cost(s1, s2) == ref.cost(s1, s2)
        got = port.dp_planes(s1, s2)
        want = ref.dp_planes(s1, s2)
        assert got.dtype == want.dtype and (got == want).all()


@pytest.mark.parametrize("below", [True, False])
def test_cost_splits_from_split_min_rows(monkeypatch, below):
    """``cost`` takes the meet-in-the-middle split from ``SPLIT_MIN_ROWS``
    rows of seq_1 and the direct fill below; both give the JAX cost."""
    rng = np.random.default_rng(78)
    monkeypatch.setattr(torch_gotoh, "SPLIT_MIN_ROWS", 6)  # a small pair
    m = 5 if below else 6
    s1 = "".join(rng.choice(list("ACGT"), m))
    s2 = "".join(rng.choice(list("ACGT"), 45))
    split_calls = []
    real = torch_gotoh.split_fill_cost
    monkeypatch.setattr(
        torch_gotoh, "split_fill_cost",
        lambda *a, **k: split_calls.append(1) or real(*a, **k),
    )
    port = tga.GotohAligner(tga.resolve_scheme(s1, s2), device="cpu")
    ref = JaxAligner(jga.resolve_scheme(s1, s2))
    assert port.cost(s1, s2) == ref.cost(s1, s2)
    assert split_calls == ([] if m < torch_gotoh.SPLIT_MIN_ROWS else [1])


def test_aligner_is_a_module_with_an_int32_cost_buffer():
    scheme = tga.resolve_scheme("ACGT", "AGT")
    aligner = tga.GotohAligner(scheme, device="cpu")
    assert isinstance(aligner, torch.nn.Module)
    buffers = dict(aligner.named_buffers())
    assert buffers["cost_mat"].dtype == torch.int32
    assert (buffers["cost_mat"].numpy() == scheme.costing.values).all()
    assert aligner.device == torch.device("cpu")


def test_past_the_moves_budget_align_is_blocked_and_equal(monkeypatch):
    """Past the moves budget ``align`` takes the blocked traceback and
    gives the same alignment as with a large budget (mirroring
    tests/test_linear_tb.py:85-100)."""
    assert torch_gotoh.DEFAULT_MOVES_BUDGET_BYTES == int(
        os.environ.get("GLOBALIGN_MOVES_BUDGET_BYTES", 64 * 1024 * 1024)
    )
    rng = np.random.default_rng(9)
    s1 = "".join(rng.choice(list("ACGT"), 150))
    s2 = "".join(rng.choice(list("ACGT"), 140))
    scheme = tga.resolve_scheme(s1, s2)
    big = tga.GotohAligner(scheme, device="cpu")
    small = tga.GotohAligner(scheme, device="cpu", moves_budget_bytes=64)
    blocked = []
    real = torch_gotoh.linear_tb.align_blocked
    monkeypatch.setattr(
        torch_gotoh.linear_tb, "align_blocked",
        lambda *a, **k: blocked.append(a[5:7]) or real(*a, **k),
    )
    assert big.align(s1, s2) == small.align(s1, s2)
    assert blocked == [(s1, s2)]  # only the small budget took the blocked path
    assert small.cost(s1, s2) == big.align(s1, s2).cost


def test_report_past_the_budget_matches_jax(monkeypatch, tmp_path):
    """``find_global_alignment`` with a tiny moves budget in both packages:
    both align blocked, and the reports are byte-identical."""
    import functools

    import globalign_tpu.api as jax_api
    import globalign_tpu_torch.api as torch_api

    monkeypatch.setattr(
        jax_api, "GotohAligner",
        functools.partial(JaxAligner, moves_budget_bytes=256),
    )
    monkeypatch.setattr(
        torch_api, "GotohAligner",
        functools.partial(tga.GotohAligner, moves_budget_bytes=256),
    )
    for k, (s1, s2) in enumerate(_pairs(31, PROTEIN, 2, 60, 120)):
        got, want = _both(seq_1=s1, seq_2=s2, scoring_mat_name="BLOSUM62")
        _assert_same(got, want)
        got.write(file=tmp_path / f"port{k}.txt")
        want.write(file=tmp_path / f"jax{k}.txt")
        assert (tmp_path / f"port{k}.txt").read_bytes() == (
            tmp_path / f"jax{k}.txt"
        ).read_bytes()


def test_cuda_request_without_a_gpu_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tga.find_global_alignment(seq_1="ACGT", seq_2="AGT")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tga.find_global_alignment(seq_1="ACGT", seq_2="AGT", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["--seq_1", "ACGT", "--seq_2", "AGT"])
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="unsupported device"):
        torch_gotoh.resolve_device("meta")


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


@pytest.fixture
def jax_without_native(monkeypatch):
    """The JAX package with its C++ host layer off (``native.load`` gives
    None): its pure-Python walk and render, which handle any letter."""
    from globalign_tpu.utils import native

    monkeypatch.setattr(native, "load", lambda: None)


def test_non_ascii_single_pairs_match_jax_without_native(
    unicode_mtx, jax_without_native, tmp_path
):
    """Strings, cost, score and report bytes under a non-ASCII custom matrix
    equal the JAX package's once its native layer is off."""
    for k, (s1, s2) in enumerate(_pairs(41, UNICODE_LETTERS, 5, 1, 60)):
        got, want = _both(seq_1=s1, seq_2=s2, scoring_mat_path=unicode_mtx)
        _assert_same(got, want)
        got.write(file=tmp_path / f"port{k}.txt")
        want.write(file=tmp_path / f"jax{k}.txt")
        assert (tmp_path / f"port{k}.txt").read_bytes() == (
            tmp_path / f"jax{k}.txt"
        ).read_bytes()


def test_non_ascii_blocked_pair_matches_jax_without_native(
    monkeypatch, unicode_mtx, jax_without_native
):
    """A pair past a lowered moves budget (the blocked traceback in both
    packages) under the non-ASCII matrix."""
    import functools

    import globalign_tpu.api as jax_api
    import globalign_tpu_torch.api as torch_api

    monkeypatch.setattr(
        jax_api, "GotohAligner",
        functools.partial(JaxAligner, moves_budget_bytes=256),
    )
    monkeypatch.setattr(
        torch_api, "GotohAligner",
        functools.partial(tga.GotohAligner, moves_budget_bytes=256),
    )
    blocked = []
    real = torch_gotoh.linear_tb.align_blocked
    monkeypatch.setattr(
        torch_gotoh.linear_tb, "align_blocked",
        lambda *a, **k: blocked.append(1) or real(*a, **k),
    )
    for s1, s2 in _pairs(43, UNICODE_LETTERS, 2, 60, 90):
        got, want = _both(seq_1=s1, seq_2=s2, scoring_mat_path=unicode_mtx)
        _assert_same(got, want)
    assert blocked == [1, 1]


def test_jax_native_layer_fails_on_non_ascii_letters(unicode_mtx):
    """ROADMAP C5, recorded: with its native layer on, the JAX package
    walks and renders UTF-8 bytes as letters, so on these pairs it raises
    or returns strings other than the port's (costs agree where it
    returns).  The port has no such layer and matches the pure-Python
    JAX path (the tests above)."""
    from globalign_tpu.utils import native

    if not native.available():  # no native layer: nothing to get wrong
        for s1, s2 in _pairs(41, UNICODE_LETTERS, 5, 1, 60):
            got, want = _both(seq_1=s1, seq_2=s2, scoring_mat_path=unicode_mtx)
            _assert_same(got, want)
        return
    wrong = 0
    for s1, s2 in _pairs(41, UNICODE_LETTERS, 5, 1, 60):
        got = tga.find_global_alignment(
            seq_1=s1, seq_2=s2, scoring_mat_path=unicode_mtx, device="cpu"
        )
        try:
            want = jga.find_global_alignment(
                seq_1=s1, seq_2=s2, scoring_mat_path=unicode_mtx
            )
        except UnicodeDecodeError:
            wrong += 1
            continue
        assert want.cost == got.cost
        wrong += (want.seq_1_aligned, want.seq_2_aligned) != (
            got.seq_1_aligned, got.seq_2_aligned
        )
    assert wrong > 0
