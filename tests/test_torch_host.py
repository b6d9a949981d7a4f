"""The port's copies of the JAX-free host modules, held against the originals.

``globalign_tpu_torch`` carries its own ``utils/{tokenize,matrices,fasta}``,
``ops/{transforms,traceback}``, ``config`` and ``results`` (importing the
JAX package's would import JAX).  These tests pin each copy to its original
on the same inputs, so the two cannot drift apart unnoticed.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from globalign_tpu.ops import fill_rows as jax_rows
from globalign_tpu.ops import traceback as jax_tb
from globalign_tpu.ops import transforms as jax_tr
from globalign_tpu.results import prettify_mat as jax_prettify
from globalign_tpu.utils import fasta as jax_fasta
from globalign_tpu.utils import matrices as jax_mat
from globalign_tpu.utils import tokenize as jax_tok
from globalign_tpu_torch.ops import fill_rows, traceback, transforms
from globalign_tpu_torch.results import prettify_mat
from globalign_tpu_torch.utils import fasta, matrices, tokenize

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["BLOSUM50", "BLOSUM62", "nucleotide"])
def test_bundled_matrices_are_identical(name):
    rel = Path("data") / "scoring_matrices" / f"{name}.mtx"
    assert (REPO / "globalign_tpu_torch" / rel).read_bytes() == (
        REPO / "globalign_tpu" / rel
    ).read_bytes()
    got = matrices.load_bundled_matrix(name)
    want = jax_mat.load_bundled_matrix(name)
    assert got.alphabet.letters == want.alphabet.letters
    assert (got.values == want.values).all()
    assert got.to_nested_dict() == want.to_nested_dict()
    assert prettify_mat(got.to_nested_dict()) == jax_prettify(
        want.to_nested_dict()
    )


def test_matrix_synthesis_and_transforms_match():
    rng = np.random.default_rng(4)
    for letters in ("ACGT", "ARNDCQEGHILKMFPSTWYV", "XYZ"):
        ta = tokenize.Alphabet.from_sequences(letters)
        ja = jax_tok.Alphabet.from_sequences(letters)
        assert ta.letters == ja.letters and ta.gap_id == ja.gap_id
        for build in ("create_scoring_mat", "create_costing_mat"):
            kw = (
                dict(match_score=3, mismatch_score=-2, gap_extension_score=-1)
                if build == "create_scoring_mat"
                else dict(mismatch_cost=4, gap_extension_cost=2)
            )
            got = getattr(matrices, build)(ta, **kw)
            want = getattr(jax_mat, build)(ja, **kw)
            assert (got.values == want.values).all()
        a = ta.size
        vals = rng.integers(-9, 10, (a, a)).astype(np.int32)
        for b in (1, 2, 5, 8):
            got = transforms.scoring_mat_to_costing_mat(
                matrices.SubstitutionMatrix(ta, vals), max_score=b
            )
            want = jax_tr.scoring_mat_to_costing_mat(
                jax_mat.SubstitutionMatrix(ja, vals), max_score=b
            )
            assert (got.values == want.values).all()
            assert transforms.split_deltas(b) == jax_tr.split_deltas(b)
            assert transforms.final_cost_to_score(
                17, 5, 9, b
            ) == jax_tr.final_cost_to_score(17, 5, 9, b)


def test_tokenize_matches_and_rejects_alike():
    a = tokenize.Alphabet.from_sequences("GATTACA", "CAT")
    j = jax_tok.Alphabet.from_sequences("GATTACA", "CAT")
    assert (a.encode("TACAG") == j.encode("TACAG")).all()
    assert a.decode(a.encode("TACAG")) == "TACAG"
    for bad in ("TAXA",):
        with pytest.raises(ValueError) as got:
            a.encode(bad)
        with pytest.raises(ValueError) as want:
            j.encode(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tokenize.Alphabet.from_sequences("A-C")


@pytest.mark.parametrize(
    "text",
    [
        ">a\nACGT\nac\n>b desc\nAGT\n\n>c\nTT\n",
        "\n\n>a\nAC\n>b\nGT",
        "ACGT\n>b\nAGT\n",
        ">a\n>b\nAGT\n",
        ">a\nAC\n>b\n",
        "",
    ],
)
def test_fasta_reader_matches(text, tmp_path):
    p = tmp_path / "in.fa"
    p.write_text(text)

    def read(mod):
        try:
            return list(mod.read_seq_from_fasta(p)), None
        except RuntimeError as e:
            return None, str(e)

    assert read(fasta) == read(jax_fasta)

    def first2(mod):
        try:
            return mod.read_first_2_seqs_from_fasta(p)
        except RuntimeError as e:
            return str(e)

    assert first2(fasta) == first2(jax_fasta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traceback_walk_matches_jax(seed):
    """The port's pure-Python row walk against the JAX package's walk (its
    native walker where built), over random fills, plus the re-pricing
    and CIGAR helpers."""
    rng = np.random.default_rng(seed)
    alpha = tokenize.Alphabet.from_sequences("ACGT")
    costing = matrices.create_costing_mat(alpha, 5, 3)
    for _ in range(4):
        m, n = (int(x) for x in rng.integers(1, 40, 2))
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        ta = np.zeros(m + 1, np.int32)
        ta[1:] = alpha.encode(s1)
        tb = np.zeros(n + 1, np.int32)
        tb[1:] = alpha.encode(s2)
        res = fill_rows.row_fill(
            torch.from_numpy(ta), torch.from_numpy(tb),
            torch.from_numpy(costing.values), alpha.gap_id, 4,
        )
        moves, final3 = res.moves.numpy(), res.final3.numpy()
        got = traceback.traceback_moves(moves, s1, s2, final3)
        want = jax_tb.traceback_moves(moves, s1, s2, final3, layout="row")
        assert got == want
        assert traceback.alignment_cost(
            got.seq_1_aligned, got.seq_2_aligned, costing, 4
        ) == got.cost
        for ext in (True, False):
            assert traceback.alignment_to_cigar(
                got.seq_1_aligned, got.seq_2_aligned, extended=ext
            ) == jax_tb.alignment_to_cigar(
                want.seq_1_aligned, want.seq_2_aligned, extended=ext
            )


def test_row_walk_on_jax_moves_equals_jax_walk():
    """The port's walk reads the JAX row scan's moves the same way."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    alpha = jax_tok.Alphabet.from_sequences("ACGT")
    cm = jax_mat.create_costing_mat(alpha, 4, 2).values
    s1 = "".join(rng.choice(list("ACGT"), 33))
    s2 = "".join(rng.choice(list("ACGT"), 27))
    ta = np.concatenate([[0], alpha.encode(s1)]).astype(np.int32)
    tb = np.concatenate([[0], alpha.encode(s2)]).astype(np.int32)
    res = jax_rows.row_fill(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm),
        jnp.int32(alpha.gap_id), jnp.int32(3),
    )
    mv, f3 = np.asarray(res.moves), np.asarray(res.final3)
    assert traceback.traceback_moves(mv, s1, s2, f3) == jax_tb.traceback_moves(
        mv, s1, s2, f3, layout="row"
    )


@pytest.mark.parametrize("alphabet,min_len,max_len,seed", [
    (["A", "C", "T", "G"], 7, 10, 19),  # the reference's golden "GTTCGCA"
    (["A", "C", "T", "G"], 5, 8, 345),
    (["the", "fat", "cat"], 7, 10, 19),
    (list("ACDEFGHIKLMNPQRSTVWY"), 0, 300, 7),
])
def test_draw_random_seq_matches_jax(alphabet, min_len, max_len, seed):
    import globalign_tpu
    import globalign_tpu_torch

    want = globalign_tpu.draw_random_seq(alphabet, min_len, max_len, seed)
    assert globalign_tpu_torch.draw_random_seq(
        alphabet, min_len, max_len, seed
    ) == want


@pytest.mark.parametrize("divergence,seeds", [
    (0.0, (1, 2)), (0.0, (5, 6)), (0.3, (19, 345)), (1.0, (7, 8)),
])
def test_draw_two_random_seqs_matches_jax(divergence, seeds):
    """Seeded draws agree; the substitution letters are drawn unseeded
    (reference start.py, as the JAX module), so past divergence 0 only
    seq_1 and seq_2's length are pinned."""
    import globalign_tpu
    import globalign_tpu_torch

    args = (["A", "C", "G", "T"], 20, 60, 10, 80, divergence, *seeds)
    want = globalign_tpu.draw_two_random_seqs(*args)
    got = globalign_tpu_torch.draw_two_random_seqs(*args)
    if divergence == 0.0:
        assert got == want
    else:
        assert got[0] == want[0] and len(got[1]) == len(want[1])


def test_the_port_exports_the_jax_package_runner_and_draws():
    import globalign_tpu
    import globalign_tpu_torch
    from globalign_tpu_torch.runner import BatchRunner

    for name in ("BatchRunner", "draw_random_seq", "draw_two_random_seqs"):
        assert name in globalign_tpu.__all__ and name in globalign_tpu_torch.__all__
    assert globalign_tpu_torch.BatchRunner is BatchRunner
