"""The anti-diagonal split cost and the dual-set batch fill, held against
the JAX package on the CPU.

``globalign_tpu_torch.ops.fill_wave`` on CPU tensors (the wave kernel's
plain version and the join) against JAX ``wave_split_fill_cost`` (TPU
kernel ``_make_wave_kernel`` in interpret mode) on the JAX tests' cases,
against the direct fill on every (m, n) in 0..5 x 0..5, and its captured
waves against the row scan's DP planes; ``ops.fill_batch.batch_final3_dual``
against JAX ``lanes_batch_final3_dual`` / ``lanes_general_final3_dual``
(TPU kernel ``_make_lane_kernel(npar=2)``, interpret mode).

Tolerance 0: costs and DP lanes are integers.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalign_tpu.config import resolve_scheme as jax_resolve_scheme
from globalign_tpu.ops import fill_lanes, fill_pallas
from globalign_tpu.ops.transforms import scoring_mat_to_costing_mat
from globalign_tpu.utils.matrices import create_scoring_mat, load_bundled_matrix
from globalign_tpu.utils.tokenize import Alphabet, encode_padded
from globalign_tpu_torch.ops import fill_batch, fill_rows, fill_wave
from globalign_tpu_torch.ops.fill_scan import BIG

ALPHA = Alphabet.from_letters(("A", "C", "G", "T", "-"))
# tests/test_fill_pallas.py's scheme: scoring 2 / -3 / -2, max score 2,
# gap open 4 (the JAX bench's wave arm, bench.py:244-251).
BENCH_COST = np.asarray(
    scoring_mat_to_costing_mat(create_scoring_mat(ALPHA, 2, -3, -2), max_score=2).values,
    np.int32,
)
BENCH_GO = 4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _jax_cases():
    """tests/test_fill_pallas.py:361-437's pairs: 14 random pairs of 2-70
    from default_rng(83), the gap-run extremes, the tiny pairs."""
    rng = np.random.default_rng(83)
    cases = []
    for _ in range(14):
        m = int(rng.integers(2, 70))
        n = int(rng.integers(2, 70))
        cases.append(("".join(rng.choice(list("ACGT"), m)),
                      "".join(rng.choice(list("ACGT"), n))))
    cases += [("AC", "AC" + "G" * 50), ("AC" + "G" * 50, "AC"),
              ("A" * 40, "A" * 3), ("GATTACA", "GATTACA")]
    cases += [("A", "C"), ("A", "A"), ("AC", "G"), ("G", "AC"), ("A", "CG")]
    return cases


def _direct(ta, tb, cm, gid, go, m, n):
    return int(fill_rows.row_fill(_t(ta), _t(tb), _t(cm), gid, go, m, n,
                                  want_moves=False).final3.min())


def _both(ta, tb, cm, gid, go, m, n):
    """(port plain, JAX interpret) costs on the same padded buffers."""
    prm = fill_wave.uniform_scheme_params(cm, gid)
    got = int(fill_wave.wave_split_fill_cost(_t(ta), _t(tb), *prm, go, m, n))
    want = int(fill_pallas.wave_split_fill_cost(
        jnp.asarray(ta), jnp.asarray(tb), *prm, go, m, n, interpret=True
    ))
    return got, want


@pytest.mark.parametrize("s1,s2", _jax_cases())
def test_wave_split_cost_matches_jax(s1, s2):
    m, n = len(s1), len(s2)
    ta = encode_padded(ALPHA, s1, 16 * -(-m // 16))
    tb = encode_padded(ALPHA, s2, 16 * -(-n // 16))
    got, want = _both(ta, tb, BENCH_COST, ALPHA.gap_id, BENCH_GO, m, n)
    assert got == want == _direct(ta, tb, BENCH_COST, ALPHA.gap_id, BENCH_GO, m, n)


@pytest.mark.parametrize("mmc,go,ge", [(5, 4, 3), (1, 7, 1), (9, 2, 6)])
def test_wave_split_cost_matches_jax_across_schemes(mmc, go, ge):
    """tests/test_fill_pallas.py:469's fuzz schemes, its pairs."""
    rng = np.random.default_rng(mmc * 100 + go * 10 + ge)
    s1 = "".join(rng.choice(list("ACGT"), 57))
    s2 = "".join(rng.choice(list("ACGT"), 43))
    scheme = jax_resolve_scheme(s1, s2, mismatch_cost=mmc, gap_open_cost=go,
                                gap_extension_cost=ge)
    cm = np.asarray(scheme.costing.values, np.int32)
    gid = scheme.alphabet.gap_id
    ta = encode_padded(scheme.alphabet, s1, 64)
    tb = encode_padded(scheme.alphabet, s2, 64)
    got, want = _both(ta, tb, cm, gid, go, len(s1), len(s2))
    assert got == want == _direct(ta, tb, cm, gid, go, len(s1), len(s2))


@pytest.mark.parametrize("m,n", list(itertools.product(range(6), range(6))))
def test_wave_split_cost_equals_the_direct_fill(m, n):
    """Every (m, n) in 0..5 x 0..5, three random pairs each, under the
    scheme of the reference fault (mismatch 5, gap open 4, extension 3),
    token buffers padded past the true lengths."""
    scheme = jax_resolve_scheme("ACGT", "ACGT", mismatch_cost=5,
                                gap_open_cost=4, gap_extension_cost=3)
    cm = np.asarray(scheme.costing.values, np.int32)
    gid = scheme.alphabet.gap_id
    prm = fill_wave.uniform_scheme_params(cm, gid)
    rng = np.random.default_rng(100 * m + n)
    for _ in range(3):
        ta = np.concatenate([[0], rng.integers(0, 4, m + 2)]).astype(np.int32)
        tb = np.concatenate([[0], rng.integers(0, 4, n + 1)]).astype(np.int32)
        got = int(fill_wave.wave_split_fill_cost(_t(ta), _t(tb), *prm, 4, m, n))
        assert got == _direct(ta, tb, cm, gid, 4, m, n)


@pytest.mark.parametrize("m,n,right,reference", [
    (0, 0, 0, -4), (0, 1, 7, 3), (1, 0, 7, 3),
])
def test_the_reference_fault_at_m_plus_n_at_most_one_is_not_copied(
    m, n, right, reference
):
    """JAX ``wave_split_fill_cost`` is wrong when m + n <= 1: the crossing
    wave is the (0, 0) corner, whose Ix / Iy lanes take the gap-open
    correction.  The port gives the direct fill's cost."""
    scheme = jax_resolve_scheme("ACGT", "ACGT", mismatch_cost=5,
                                gap_open_cost=4, gap_extension_cost=3)
    cm = np.asarray(scheme.costing.values, np.int32)
    gid = scheme.alphabet.gap_id
    ta = np.array([0, 1, 0, 0][: m + 2], np.int32)
    tb = np.array([0, 2, 0][: n + 2], np.int32)
    got, want = _both(ta, tb, cm, gid, 4, m, n)
    assert got == right == _direct(ta, tb, cm, gid, 4, m, n)
    assert want == reference


def _assert_frontier_matches_planes(out_p, ta, tb, cm, gid, go, m, n, waves):
    """Each captured wave equals the row scan's planes at its reached rows
    (i, t-i), max(0, t-n) <= i <= min(t, m), and is BIG at every other."""
    planes = fill_rows.row_fill(_t(ta), _t(tb), _t(cm), gid, go, m, n,
                                want_moves=False, want_planes=True).planes
    for k, t in enumerate(waves):
        for i in range(out_p.shape[-1]):
            got = out_p[k, :, i].tolist()
            if t >= 0 and max(0, t - n) <= i <= min(t, m):
                assert got == planes[:, i, t - i].tolist(), (k, t, i)
            else:
                assert got == [BIG] * 3, (k, t, i)


@pytest.mark.parametrize("m,n", [(0, 0), (1, 0), (0, 3), (1, 1), (9, 4), (5, 23),
                                 (31, 30)])
def test_wave_frontiers_equal_the_row_scan_planes(m, n):
    """The forward frontier is the pair's DP at waves T-1 and T; the
    reversed frontier is the reversed pair's DP at waves tmax-1 and tmax
    (buffers padded by two rows and one column)."""
    rng = np.random.default_rng(7 * m + n)
    ta = np.concatenate([[0], rng.integers(0, 4, m + 2)]).astype(np.int32)
    tb = np.concatenate([[0], rng.integers(0, 4, n + 1)]).astype(np.int32)
    gid = ALPHA.gap_id
    prm = fill_wave.uniform_scheme_params(BENCH_COST, gid)
    out = fill_wave.wave_frontiers(_t(ta), _t(tb), *prm, BENCH_GO, m, n)
    assert out.shape == (2, 2, 3, m + 3) and out.dtype == torch.int32
    fwd, rev = fill_wave.capture_waves(m, n)
    _assert_frontier_matches_planes(out[0], ta, tb, BENCH_COST, gid, BENCH_GO,
                                    m, n, fwd)
    ta_r = np.concatenate([[0], ta[1 : m + 1][::-1]])
    tb_r = np.concatenate([[0], tb[1 : n + 1][::-1]])
    _assert_frontier_matches_planes(out[1, :, :, : m + 1], ta_r, tb_r,
                                    BENCH_COST, gid, BENCH_GO, m, n, rev)


@pytest.mark.parametrize("kw", [
    {}, dict(match_score=3, mismatch_score=-2, gap_open_score=-5,
             gap_extension_score=-1),
    dict(mismatch_cost=9, gap_open_cost=2, gap_extension_cost=6),
])
def test_uniform_scheme_params_match_jax(kw):
    scheme = jax_resolve_scheme("ACGT", "ACGTT", **kw)
    cm = np.asarray(scheme.costing.values)
    gid = scheme.alphabet.gap_id
    want = fill_pallas.uniform_scheme_params(cm, gid)
    assert want is not None
    assert fill_wave.uniform_scheme_params(cm, gid) == want
    assert fill_wave.uniform_scheme_params(_t(cm), gid) == want


def test_uniform_scheme_params_declines_blosum62():
    scoring = load_bundled_matrix("BLOSUM62")
    b62 = scoring_mat_to_costing_mat(scoring, max_score=int(scoring.values.max()))
    assert fill_pallas.uniform_scheme_params(b62.values, b62.alphabet.gap_id) is None
    assert fill_wave.uniform_scheme_params(b62.values, b62.alphabet.gap_id) is None


def test_wave_frontiers_check_inputs_and_have_no_other_route():
    ta = torch.zeros(5, dtype=torch.int32)
    tb = torch.zeros(3, dtype=torch.int32)
    prm = (0, 5, 3, 3, 4)
    assert fill_wave.wave_split_fill_cost(ta, tb, *prm, 4, 2).dim() == 0
    with pytest.raises(ValueError, match="outside the buffers"):
        fill_wave.wave_frontiers(ta, tb, *prm, 5, 2)
    with pytest.raises(TypeError, match="int32"):
        fill_wave.wave_frontiers(ta.long(), tb, *prm, 4, 2)
    with pytest.raises(ValueError, match="1-D"):
        fill_wave.wave_frontiers(ta[None], tb, *prm, 0, 2)
    meta = [torch.zeros(x.shape, dtype=torch.int32, device="meta") for x in (ta, tb)]
    before = fill_wave.wave_frontiers.launches
    with pytest.raises(ValueError, match="no wave_split route"):
        fill_wave.wave_frontiers(*meta, *prm, 4, 2)
    with pytest.raises(ValueError, match="tok_b is on"):
        fill_wave.wave_frontiers(ta, meta[1], *prm, 4, 2)
    assert fill_wave.wave_frontiers.launches == before


@pytest.mark.parametrize("m,want", [(0, (32, 1)), (31, (32, 1)), (32, (64, 1)),
                                    (1023, (1024, 1)), (1024, (1024, 2)),
                                    (50_000, (1024, 49))])
def test_wave_kernel_plan(m, want):
    threads, seg = fill_wave.plan(m)
    assert (threads, seg) == want and threads * seg >= m + 1


# -- batch_final3_dual against TPU kernel #11 (npar = 2) ---------------------


def _dual_inputs():
    rng = np.random.default_rng(111)
    B, M, N = 4, 24, 40
    ta = rng.integers(1, 5, (2, B, M + 1)).astype(np.int32)
    tb = rng.integers(1, 5, (2, B, N + 1)).astype(np.int32)
    ta[..., 0] = 0
    tb[..., 0] = 0
    m2 = np.array([[24, 0, 7, 13], [1, 24, 19, 0]], np.int32)
    n2 = np.array([[40, 17, 0, 33], [40, 1, 29, 5]], np.int32)
    return ta, tb, m2, n2


def _per_set(ta, tb, cm, gid, go, m2, n2):
    return torch.stack([
        fill_batch.batch_final3(_t(ta[s]), _t(tb[s]), _t(cm), gid, go, m2[s], n2[s])
        for s in range(2)
    ])


def test_batch_final3_dual_matches_lanes_batch_final3_dual():
    """The uniform form: (cmatch, cmismatch, dcost, icost) = (0, 5, 3, 2),
    reached by the port through the scheme's costing matrix."""
    ta, tb, m2, n2 = _dual_inputs()
    cmatch, cmismatch, dcost, icost, go = 0, 5, 3, 2, 4
    gid = 5
    cm = np.full((6, 6), cmismatch, np.int32)
    np.fill_diagonal(cm, cmatch)
    cm[gid, :] = dcost
    cm[:, gid] = icost
    cm[gid, gid] = 0
    want = np.asarray(fill_lanes.lanes_batch_final3_dual(
        jnp.asarray(ta), jnp.asarray(tb), cmatch, cmismatch, dcost, icost, go,
        jnp.asarray(m2), jnp.asarray(n2), interpret=True,
    ))
    got = fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), gid, go, m2, n2)
    assert got.shape == (2, 4, 3)
    assert (got.numpy() == want).all()
    assert torch.equal(got, _per_set(ta, tb, cm, gid, go, m2, n2))


def test_batch_final3_dual_matches_lanes_general_final3_dual():
    """Any matrix: a random non-uniform 6 x 6 costing matrix, gap id 5."""
    ta, tb, m2, n2 = _dual_inputs()
    rng = np.random.default_rng(112)
    gid, go = 5, 3
    cm = rng.integers(0, 9, (6, 6)).astype(np.int32)
    cm[gid, gid] = 0
    want = np.asarray(fill_lanes.lanes_general_final3_dual(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cm), gid, go,
        jnp.asarray(m2), jnp.asarray(n2), interpret=True,
    ))
    got = fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), gid, go, m2, n2)
    assert (got.numpy() == want).all()
    assert torch.equal(got, _per_set(ta, tb, cm, gid, go, m2, n2))


def test_batch_final3_dual_checks_its_inputs():
    ta, tb, m2, n2 = _dual_inputs()
    cm = np.zeros((6, 6), np.int32)
    with pytest.raises(ValueError, match=r"\(2, B, M\+1\)"):
        fill_batch.batch_final3_dual(_t(ta[0]), _t(tb[0]), _t(cm), 5, 4, m2, n2)
    with pytest.raises(ValueError, match="m2 must have shape"):
        fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), 5, 4, m2[0], n2)
    with pytest.raises(ValueError, match="contiguous"):
        fill_batch.batch_final3_dual(
            _t(ta).transpose(1, 2).contiguous().transpose(1, 2), _t(tb),
            _t(cm), 5, 4, m2, n2,
        )
    with pytest.raises(ValueError, match="lie in"):
        fill_batch.batch_final3_dual(_t(ta), _t(tb), _t(cm), 5, 4, m2 + 1, n2)
