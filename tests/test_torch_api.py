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


def test_aligner_is_a_module_with_an_int32_cost_buffer():
    scheme = tga.resolve_scheme("ACGT", "AGT")
    aligner = tga.GotohAligner(scheme, device="cpu")
    assert isinstance(aligner, torch.nn.Module)
    buffers = dict(aligner.named_buffers())
    assert buffers["cost_mat"].dtype == torch.int32
    assert (buffers["cost_mat"].numpy() == scheme.costing.values).all()
    assert aligner.device == torch.device("cpu")


def test_moves_budget_refuses_instead_of_falling_back():
    assert torch_gotoh.DEFAULT_MOVES_BUDGET_BYTES == int(
        os.environ.get("GLOBALIGN_MOVES_BUDGET_BYTES", 64 * 1024 * 1024)
    )
    scheme = tga.resolve_scheme("ACGTACGT", "ACGTAC")
    aligner = tga.GotohAligner(scheme, device="cpu", moves_budget_bytes=62)
    assert aligner.align("ACGTACGT", "ACGTA").cost >= 0  # 9 * 6 = 54 bytes
    with pytest.raises(NotImplementedError, match="not yet ported"):
        aligner.align("ACGTACGT", "ACGTAC")  # 9 * 7 = 63 bytes
    assert aligner.cost("ACGTACGT", "ACGTAC") >= 0  # cost-only needs no moves


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
