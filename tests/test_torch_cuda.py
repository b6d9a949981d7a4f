"""The CUDA kernel against its plain version — needs an NVIDIA GPU.

Every test here is marked ``cuda`` and skips (inside the ``cuda_device``
fixture) where no CUDA device is present.  This file imports neither JAX
nor the JAX package, so on a machine with the card and without JAX it runs
alone:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q

Tolerance 0: final3 and every move code are integers.
"""

import numpy as np
import pytest
import torch

from globalign_tpu_torch import find_global_alignment, resolve_scheme
from globalign_tpu_torch.ops import fill_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _case(rng, letters, shapes, **scheme_kw):
    pairs = [
        ("".join(rng.choice(list(letters), m)),
         "".join(rng.choice(list(letters), n)))
        for m, n in shapes
    ]
    scheme = resolve_scheme(
        "".join(letters), "".join(letters), **scheme_kw
    )
    ta = np.zeros((len(pairs), max(m for m, _ in shapes) + 1), np.int32)
    tb = np.zeros((len(pairs), max(n for _, n in shapes) + 1), np.int32)
    for b, (s1, s2) in enumerate(pairs):
        ta[b, 1 : len(s1) + 1] = scheme.alphabet.encode(s1)
        tb[b, 1 : len(s2) + 1] = scheme.alphabet.encode(s2)
    cost = np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
    return (
        torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cost),
        scheme.alphabet.gap_id, scheme.gap_open_cost,
        [m for m, _ in shapes], [n for _, n in shapes],
    )


def _on(dev, args):
    ta, tb, cost, *rest = args
    return (ta.to(dev), tb.to(dev), cost.to(dev), *rest)


def _assert_kernel_equals_plain(dev, args):
    want3, want_mv = fill_cuda.batch_moves(*args)
    before = fill_cuda.batch_moves.launches
    got3, got_mv = fill_cuda.batch_moves(*_on(dev, args))
    torch.cuda.synchronize()
    assert fill_cuda.batch_moves.launches == before + 1
    assert torch.equal(got3.cpu(), want3)
    assert torch.equal(got_mv.cpu(), want_mv)
    cost3, none = fill_cuda.batch_moves(*_on(dev, args), want_moves=False)
    assert none is None and torch.equal(cost3.cpu(), want3)


@pytest.mark.parametrize(
    "shapes",
    [[(1, 1)], [(0, 5)], [(7, 0)], [(0, 0)], [(33, 65)],
     [(40, 3), (5, 90), (64, 64), (1, 1)]],
)
def test_kernel_matches_plain_small(cuda_device, shapes):
    rng = np.random.default_rng(len(shapes) + shapes[0][0])
    _assert_kernel_equals_plain(cuda_device, _case(rng, "ACGT", shapes))


def test_kernel_matches_plain_blosum_and_odd_scheme(cuda_device):
    rng = np.random.default_rng(5)
    _assert_kernel_equals_plain(
        cuda_device,
        _case(rng, "ARNDCQEGHILKMFPSTWYV", [(120, 200)],
              scoring_mat_name="BLOSUM62"),
    )
    _assert_kernel_equals_plain(
        cuda_device,
        _case(rng, "ACGT", [(150, 97)], match_score=3, mismatch_score=-2,
              gap_open_score=-5, gap_extension_score=-1),
    )


def test_kernel_matches_plain_with_the_table_in_global_memory(cuda_device):
    """A 400-letter alphabet: its 640 KB cost table exceeds shared memory,
    so the kernel reads it from global memory."""
    rng = np.random.default_rng(6)
    letters = "".join(chr(0x4E00 + k) for k in range(399))
    _assert_kernel_equals_plain(cuda_device, _case(rng, letters, [(60, 80)]))


def test_kernel_matches_plain_with_the_strip_state_in_global_memory(cuda_device):
    """20 000 columns: the strips' row state (16 bytes a column) exceeds
    shared memory and lives in the per-pair global scratch."""
    rng = np.random.default_rng(7)
    _assert_kernel_equals_plain(cuda_device, _case(rng, "ACGT", [(9, 20000)]))


def test_main_path_runs_the_kernel(cuda_device):
    rng = np.random.default_rng(8)
    s1 = "".join(rng.choice(list("ACGT"), 300))
    s2 = "".join(rng.choice(list("ACGT"), 280))
    before = fill_cuda.batch_moves.launches
    got = find_global_alignment(seq_1=s1, seq_2=s2, device="cuda")
    assert fill_cuda.batch_moves.launches == before + 1
    want = find_global_alignment(seq_1=s1, seq_2=s2, device="cpu")
    assert got == want and str(got) == str(want)


def test_kernel_rejects_mixed_devices(cuda_device):
    args = _case(np.random.default_rng(9), "ACGT", [(4, 4)])
    ta, tb, cost, *rest = _on(cuda_device, args)
    with pytest.raises(ValueError, match="is on"):
        fill_cuda.batch_moves(ta, tb, cost.cpu(), *rest)
