"""The port's reference-layout package held against the JAX package's shim.

``globalign_tpu_torch.compat`` (``start``, ``conclude``, ``globaligner``,
``dp_compat``) against ``globalign`` on the CPU, tolerance 0: every public
name present, the reference goldens (strings, cost, score, ``str``), the
nested-dict helpers with their key order, the 7-tuple and the reference's
input cap at its edge, the error surfaces (type and message), report bytes
of ``main``, and the interpreted DP adapters on seeded pairs.  The port's
side passes ``device="cpu"`` / ``--device cpu``; its default is the card.
"""

import importlib
import inspect
import json
import random
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import globalign
import globalign.conclude
import globalign.dp_compat
import globalign.globaligner
import globalign.start
import globalign_tpu_torch.compat as compat
from globalign_tpu_torch import api as torch_api
from globalign_tpu_torch.compat import conclude, dp_compat, globaligner, start
from globalign_tpu_torch.config import DEFAULT_MAX_SEQ_LEN_PROD, resolve_scheme
from globalign_tpu_torch.models.gotoh import GotohAligner
from tests.test_compat_shim import REFERENCE_E2E

REPO = Path(__file__).resolve().parents[1]
DNA = "ACGT"
PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
MODULES = {
    "start": (globalign.start, start),
    "conclude": (globalign.conclude, conclude),
    "globaligner": (globalign.globaligner, globaligner),
    "dp_compat": (globalign.dp_compat, dp_compat),
}
# The reference's input cap is m * n < 2e7 (reference start.py:213).
CAP_ACCEPTED = (4472, 4472)  # 19 998 784
CAP_REFUSED = (4473, 4472)  # 20 003 256


def _public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


def _ordered(mat) -> str:
    """A nested dict as text that keeps its key order."""
    return json.dumps(mat)


def _seq(rng, letters: str, length: int) -> str:
    return "".join(rng.choice(list(letters), length))


def _raised(fn):
    try:
        fn()
    except (Exception, SystemExit) as e:  # argparse exits on a bad choice
        return type(e), str(e)
    raise AssertionError("no exception raised")


# -- import layout ------------------------------------------------------

def test_import_layout():
    assert compat.find_global_alignment is compat.globaligner.find_global_alignment
    assert compat.find_global_alignment is torch_api.find_global_alignment
    assert compat.start is start and compat.conclude is conclude
    assert compat.globaligner is globaligner
    assert globaligner.dp_array_forward is dp_compat.dp_array_forward


@pytest.mark.parametrize("name", sorted(MODULES))
def test_every_public_name_has_a_counterpart(name):
    ref, port = MODULES[name]
    missing = [n for n in _public(ref) if not hasattr(port, n)]
    assert not missing, missing
    for n in _public(ref):
        want, got = getattr(ref, n), getattr(port, n)
        assert callable(want) == callable(got), n
        if inspect.isfunction(want) and name != "globaligner":
            assert list(inspect.signature(got).parameters) == list(
                inspect.signature(want).parameters), n


def test_find_global_alignment_defaults_to_the_card():
    sig = inspect.signature(compat.find_global_alignment)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["max_seq_len_prod"].default == DEFAULT_MAX_SEQ_LEN_PROD
    assert globaligner.main is importlib.import_module(
        "globalign_tpu_torch.cli").main


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the call would run")
def test_default_device_raises_without_a_gpu(capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.find_global_alignment(seq_1="ACGT", seq_2="AGT")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        globaligner.main(["--seq_1", "ACGT", "--seq_2", "AGT"])
    assert capsys.readouterr().out == ""


# -- goldens --------------------------------------------------------------

@pytest.mark.parametrize("case", REFERENCE_E2E)
def test_reference_goldens(case):
    case = dict(case)
    golden = case.pop("score"), case.pop("cost")
    want = globalign.find_global_alignment(**case)
    got = compat.find_global_alignment(**case, device="cpu")
    assert (got.score, got.cost) == golden
    assert tuple(got) == tuple(want)
    assert str(got) == str(want)


@pytest.mark.parametrize("opts", [
    dict(letters=DNA),
    dict(letters=DNA, match_score=3, mismatch_score=-4, gap_open_score=-5,
         gap_extension_score=-2),
    dict(letters=PROTEIN, scoring_mat_name="BLOSUM62"),
], ids=["default", "odd-b", "blosum62"])
def test_seeded_pairs_match(opts):
    opts = dict(opts)
    letters = opts.pop("letters")
    rng = np.random.default_rng(9)
    for _ in range(4):
        m, n = (int(x) for x in rng.integers(1, 60, 2))
        kw = dict(seq_1=_seq(rng, letters, m), seq_2=_seq(rng, letters, n), **opts)
        want = globalign.globaligner.find_global_alignment(**kw)
        got = globaligner.find_global_alignment(**kw, device="cpu")
        assert tuple(got) == tuple(want)
        assert str(got) == str(want)


# -- nested-dict helpers --------------------------------------------------

def test_get_common_alphabet_and_allocators():
    assert start.get_common_alphabet("GATTACA", "CAT") == \
        globalign.start.get_common_alphabet("GATTACA", "CAT")
    assert start.make_matrix(2, 3, 0) == globalign.start.make_matrix(2, 3, 0)
    grid = start.make_matrix(2, 2, 0)
    grid[0][0] = 9
    assert grid[1][0] == 0
    cube = start.make_3d_array(2, 3, 2, "x")
    assert cube == globalign.start.make_3d_array(2, 3, 2, "x")
    cube[0][0][0] = "y"
    assert cube[1][0][0] == "x"


@pytest.mark.parametrize("fn,args", [
    ("create_scoring_mat", (2, -3, -2)),
    ("create_costing_mat", (5, 3)),
])
def test_create_mat_mutates_the_callers_list(fn, args):
    mine, theirs = ["T", "A", "C"], ["T", "A", "C"]
    got = getattr(start, fn)(mine, *args)
    want = getattr(globalign.start, fn)(theirs, *args)
    assert mine == theirs == ["T", "A", "C", "-"]
    assert _ordered(got) == _ordered(want)


@pytest.mark.parametrize("max_score,deltas", [
    (3, {}), (5, {}), (4, {}), (3, dict(delta_d=2, delta_i=1)),
])
def test_matrix_transforms_both_ways(max_score, deltas):
    scoring = globalign.start.create_scoring_mat(list(DNA), max_score, -4, -2)
    costing = start.scoring_mat_to_costing_mat(scoring, max_score, **deltas)
    assert _ordered(costing) == _ordered(
        globalign.start.scoring_mat_to_costing_mat(scoring, max_score, **deltas))
    back = start.costing_mat_to_scoring_mat(costing, max_score, **deltas)
    assert _ordered(back) == _ordered(
        globalign.start.costing_mat_to_scoring_mat(costing, max_score, **deltas))
    assert _ordered(back) == _ordered(scoring)
    for fn in ("final_cost_to_score", "final_score_to_cost"):
        assert getattr(conclude, fn)(17, 9, 6, max_score, **deltas) == getattr(
            globalign.conclude, fn)(17, 9, 6, max_score, **deltas)


@pytest.mark.parametrize("name", ["BLOSUM50", "BLOSUM62"])
def test_read_scoring_mat_on_the_bundled_files(name):
    port_file = REPO / "globalign_tpu_torch" / "data" / "scoring_matrices" / f"{name}.mtx"
    jax_file = REPO / "globalign_tpu" / "data" / "scoring_matrices" / f"{name}.mtx"
    got = start.read_scoring_mat(port_file)
    want = globalign.start.read_scoring_mat(jax_file)
    assert _ordered(got) == _ordered(want)
    assert _ordered(start.read_scoring_mat(jax_file)) == _ordered(want)
    assert start.check_symmetric(got) == globalign.start.check_symmetric(want)
    assert start.check_big_main_diag(got) == globalign.start.check_big_main_diag(want)
    assert start.get_max_val(got) == globalign.start.get_max_val(want)
    assert conclude.prettify_mat(got) == globalign.conclude.prettify_mat(want)


def test_print_nested_list_aligned(capsys):
    rows = [[(0, 7, 7), (6, 3, 9)], [(4, 10, 4), None]]
    conclude.print_nested_list_aligned(rows)
    got = capsys.readouterr().out
    globalign.conclude.print_nested_list_aligned(rows)
    assert got == capsys.readouterr().out


def test_random_seqs_match(monkeypatch):
    assert start.draw_random_seq(list(DNA), 5, 40, seed=3) == \
        globalign.start.draw_random_seq(list(DNA), 5, 40, seed=3)
    # draw_two_random_seqs reseeds from the OS (seed None) for its edits,
    # as the reference does: pin that seed so both draws can be compared.
    real_seed = random.seed
    monkeypatch.setattr(random, "seed",
                        lambda a=None, **kw: real_seed(7 if a is None else a))
    args = (list(PROTEIN), 10, 30, 12, 35, 0.3, 5, 6)
    got = start.draw_two_random_seqs(*args)
    assert got == globalign.start.draw_two_random_seqs(*args)
    assert got == start.draw_two_random_seqs(*args)


# -- validate_and_transform_args ------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seq_1="ACGT", seq_2="AGT"),
    dict(seq_1="gattaca", seq_2="GCATGCT", mismatch_cost=4, gap_open_cost=2,
         gap_extension_cost=1),
    dict(seq_1="HEAGAWGHEE", seq_2="PAWHEAE", scoring_mat_name="BLOSUM50",
         gap_open_score=-6),
    dict(seq_1="TT", seq_2="TA", match_score=3, mismatch_score=-4,
         gap_open_score=-5, gap_extension_score=-2),
], ids=["default", "costs", "blosum50", "odd-b"])
def test_validate_and_transform_args_seven_tuple(kw):
    got = start.validate_and_transform_args(**kw)
    want = globalign.start.validate_and_transform_args(**kw)
    assert len(got) == 7
    assert got == want
    assert _ordered(got[2:4]) == _ordered(want[2:4])


def test_validate_and_transform_args_cap_edge():
    rng = np.random.default_rng(4472)
    for shim in (start, globalign.start):
        m, n = CAP_ACCEPTED
        out = shim.validate_and_transform_args(
            seq_1=_seq(rng, DNA, m), seq_2=_seq(rng, DNA, n))
        assert (len(out[0]), len(out[1])) == CAP_ACCEPTED
    m, n = CAP_REFUSED
    kw = dict(seq_1=_seq(rng, DNA, m), seq_2=_seq(rng, DNA, n))
    got = _raised(lambda: start.validate_and_transform_args(**kw))
    want = _raised(lambda: globalign.start.validate_and_transform_args(**kw))
    assert got == want
    assert "too long" in got[1] and "20000000" in got[1]


def test_find_global_alignment_keeps_the_lifted_cap(monkeypatch):
    """Past the reference's cap the port's entry point validates and goes on
    to build its aligner (stopped here before the fill)."""

    class Reached(Exception):
        pass

    def stop(scheme, **kwargs):
        raise Reached(kwargs)

    monkeypatch.setattr(torch_api, "GotohAligner", stop)
    rng = np.random.default_rng(4473)
    m, n = CAP_REFUSED
    with pytest.raises(Reached) as info:
        compat.find_global_alignment(seq_1=_seq(rng, DNA, m),
                                     seq_2=_seq(rng, DNA, n))
    assert info.value.args[0] == {"device": "cuda"}


# -- error surfaces -------------------------------------------------------

def test_check_symmetric_on_a_list():
    got = _raised(lambda: start.check_symmetric([[0, 1], [1, 0]]))
    want = _raised(lambda: globalign.start.check_symmetric([[0, 1], [1, 0]]))
    assert got[0] is want[0] is AttributeError


ERROR_CASES = {
    "gap in a sequence": dict(seq_1="AC-GT", seq_2="AGT"),
    "score and cost options": dict(seq_1="ACGT", seq_2="AGT", match_score=2,
                                   mismatch_cost=5),
    "missing seq_2": dict(seq_1="ACGT"),
    "unknown matrix name": dict(seq_1="HEAG", seq_2="PAW",
                                scoring_mat_name="BLOSUM99"),
    "matrix name and scores": dict(seq_1="HEAG", seq_2="PAW",
                                   scoring_mat_name="BLOSUM62", match_score=2),
    "empty sequence": dict(seq_1="", seq_2="AGT"),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_error_surfaces(name, capsys):
    kw = ERROR_CASES[name]
    want = _raised(lambda: globalign.find_global_alignment(**kw))
    for fn in (lambda: compat.find_global_alignment(**kw, device="cpu"),
               lambda: compat.find_global_alignment(**kw),
               lambda: start.validate_and_transform_args(**kw)):
        assert _raised(fn) == want
    wanted = _raised(lambda: globalign.start.validate_and_transform_args(**kw))
    assert wanted == want
    capsys.readouterr()


def test_existing_output_file(tmp_path):
    out = tmp_path / "taken.txt"
    out.write_text("keep me")
    kw = dict(seq_1="ACGT", seq_2="AGT", output=str(out))
    want = _raised(lambda: globalign.find_global_alignment(**kw))
    assert want[0] is RuntimeWarning
    assert _raised(lambda: compat.find_global_alignment(**kw, device="cpu")) == want
    assert _raised(lambda: start.validate_and_transform_args(**kw)) == want
    argv = ["--seq_1", "ACGT", "--seq_2", "AGT", "-o", str(out)]
    assert _raised(lambda: globaligner.main(argv + ["--device", "cpu"])) == \
        _raised(lambda: globalign.globaligner.main(argv))
    assert out.read_text() == "keep me"


def test_main_unknown_matrix_name(capsys):
    argv = ["--seq_1", "HEAG", "--seq_2", "PAW", "--scoring_mat_name", "BLOSUM99"]
    got = _raised(lambda: globaligner.main(argv + ["--device", "cpu"]))
    got_err = capsys.readouterr().err
    want = _raised(lambda: globalign.globaligner.main(argv))
    want_err = capsys.readouterr().err
    assert got == want and got[0] is SystemExit
    assert "invalid choice: 'BLOSUM99'" in got_err
    assert got_err.splitlines()[-1] == want_err.splitlines()[-1]


# -- main -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["simple", "blosum62-fasta", "costs", "stdout"])
def test_main_report_bytes(case, tmp_path, capsys):
    rng = np.random.default_rng(17)
    if case == "blosum62-fasta":
        fasta = tmp_path / "pair.fasta"
        fasta.write_text(f">a\n{_seq(rng, PROTEIN, 70)}\n>b\n"
                         f"{_seq(rng, PROTEIN, 64)}\n>c\nAAAA\n")
        argv = ["-i", str(fasta), "--scoring_mat_name", "BLOSUM62"]
    elif case == "costs":
        argv = ["--seq_1", _seq(rng, DNA, 90), "--seq_2", _seq(rng, DNA, 75),
                "--mismatch_cost", "4", "--gap_open_cost", "6",
                "--gap_extension_cost", "1"]
    else:
        argv = ["--seq_1", _seq(rng, DNA, 150), "--seq_2", _seq(rng, DNA, 140)]
    if case == "stdout":
        assert globaligner.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        globalign.globaligner.main(argv)
        assert got == capsys.readouterr().out and "cost: " in got
        return
    port_out, jax_out = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert globaligner.main(argv + ["--device", "cpu", "-o", str(port_out)]) == 0
    globalign.globaligner.main(argv + ["-o", str(jax_out)])
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert b"# Settings" in port_out.read_bytes()


# -- dp_compat ------------------------------------------------------------

DP_SCHEMES = {
    "default": dict(letters=DNA),
    "odd-b": dict(letters=DNA, match_score=3, mismatch_score=-4,
                  gap_open_score=-5, gap_extension_score=-2),
    "blosum62-subset": dict(letters="ACDEHKLW", scoring_mat_name="BLOSUM62"),
}


def _dp_case(name):
    opts = dict(DP_SCHEMES[name])
    letters = opts.pop("letters")
    scheme = resolve_scheme(letters, letters, **opts)
    costing = scheme.costing.to_nested_dict()
    return letters, scheme, costing, start.get_max_val(costing), scheme.gap_open_cost


@pytest.mark.parametrize("name", sorted(DP_SCHEMES))
def test_dp_compat_matches_the_shim(name):
    letters, scheme, costing, max_cost, go = _dp_case(name)
    rng = np.random.default_rng(12)
    aligner = GotohAligner(scheme, device="cpu")
    for k in range(20):
        m, n = (int(x) for x in rng.integers(0, 13, 2))
        if k < 2:
            m, n = (0, n) if k == 0 else (m, 0)
        s1, s2 = _seq(rng, letters, m), _seq(rng, letters, n)
        got = dp_compat.make_dp_array(s1, s2, costing, max_cost, go)
        want = globalign.dp_compat.make_dp_array(s1, s2, costing, max_cost, go)
        assert got == want
        for i in range(1, m + 1):  # each cell from the shim's neighbours
            for j in range(1, n + 1):
                assert dp_compat.get_next_best_costs(
                    want, i, j, s1, s2, costing, go
                ) == globalign.dp_compat.get_next_best_costs(
                    want, i, j, s1, s2, costing, go)
                want[i][j] = globalign.dp_compat.get_next_best_costs(
                    want, i, j, s1, s2, costing, go)
        assert dp_compat.dp_array_forward(got, s1, s2, costing, go) is None
        assert got == want
        back = dp_compat.dp_array_backward(got, s1, s2, costing, go)
        assert back == globalign.dp_compat.dp_array_backward(
            want, s1, s2, costing, go)
        if m and n:
            assert back[3] == aligner.cost(s1, s2)


def test_dp_array_forward_reference_golden():
    """The reference's own golden for dp_array_forward
    (reference tests/globaligner_test.py:6-37)."""
    dp_array = [
        [(0, 7, 7), (6, 3, 9), (5, 5, 11)],
        [(4, 10, 4), None, None],
        [(10, 13, 7), None, None],
    ]
    costing_mat = {
        "A": {"A": 0, "G": 3, "-": 3},
        "G": {"A": 3, "G": 0, "-": 3},
        "-": {"A": 2, "G": 2, "-": 0},
    }
    globaligner.dp_array_forward(dp_array, "AG", "GA", costing_mat, 1)
    assert dp_array == [
        [(0, 7, 7), (6, 3, 9), (5, 5, 11)],
        [(4, 10, 4), (3, 7, 7), (3, 6, 9)],
        [(10, 13, 7), (4, 10, 7), (6, 7, 7)],
    ]


def test_dp_compat_take_functions():
    outs = []
    for mod in (dp_compat, globalign.dp_compat):
        o1, mid, o2 = [], [], []
        mod.take_match("AC", "AG", 0, 0, o1, mid, o2)
        mod.take_mismatch("AC", "AG", 1, 1, o1, mid, o2)
        mod.take_gap_in_seq_1("AC", "AG", 1, 1, o1, mid, o2)
        mod.take_gap_in_seq_2("AC", "AG", 1, 1, o1, mid, o2)
        outs.append((o1, mid, o2))
    assert outs[0] == outs[1] == (["A", "C", "-", "C"], ["|", "*", " ", " "],
                                  ["A", "G", "G", "-"])


# -- console scripts ------------------------------------------------------

TORCH_SCRIPTS = {
    "tpalign-torch": "globalign_tpu_torch.cli:main",
    "globaligner-torch": "globalign_tpu_torch.compat.globaligner:main",
    "tpalign-batch-torch": "globalign_tpu_torch.batch_cli:main",
}


@pytest.mark.parametrize("script", sorted(TORCH_SCRIPTS))
def test_console_scripts(script):
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts[script] == TORCH_SCRIPTS[script]
    assert sorted(s for s in scripts if s.endswith("-torch")) == sorted(TORCH_SCRIPTS)
    module, attr = scripts[script].split(":")
    assert module.split(".")[0] == "globalign_tpu_torch"
    assert callable(getattr(importlib.import_module(module), attr))
