"""The launch plan of each benchmark cell, from the host rules alone.

Each cell's pairs come from its own traffic file through the benchmark's
generator (read-only), and the rules that pick its kernels run as they do on
an NVIDIA H100 80GB HBM3: 132 SMs and 85.0 GB of memory.  The kernel
instances named here are the ones the cells' device traces show
(``gotoh_tile_kernel<H, W, MOVES, TSMEM>``,
``gotoh_batch_kernel<W, LAST, ...>``,
``gotoh_fill_kernel<W, MOVES, TSMEM, RAGGED>``), every template argument
held to the rule that picks it; TSMEM (the cost table in shared memory) is
the launchers' own rule, with the constants read from their sources.  A
change of route shows here on the CPU before a card run.
"""

import functools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import traffic
from globalign_tpu_torch import batch, resolve_scheme
from globalign_tpu_torch.batch import bucket_length
from globalign_tpu_torch.models.gotoh import DEFAULT_MOVES_BUDGET_BYTES
from globalign_tpu_torch.ops import fill_batch, fill_cuda, fill_tile, linear_tb

SMS = 132  # an H100 80GB HBM3
CARD_MEMORY = 85_000_000_000  # its total memory, bytes
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CSRC = Path(__file__).resolve().parents[1] / "globalign_tpu_torch" / "csrc"
DNA_TABLE = len(resolve_scheme("ACGT", "ACGT").costing.values)


def _instance(name: str) -> tuple:
    """``kernel<a,b,...>`` -> its template arguments (ints and bools)."""
    args = name.split("<")[1].rstrip(">").split(",")
    return tuple(int(a) if a.isdigit() else a == "true" for a in args)


@functools.cache
def _constants(stem: str) -> dict:
    """The ``constexpr int NAME = <number>;`` lines of a CUDA source."""
    text = (CSRC / f"{stem}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _slot_bytes(width: int) -> int:
    """A staged code row's bytes (``slot_bytes<W>`` in both fill sources)."""
    return 32 * width + (8 if (width // 4) % 2 else 4)


def _tile_table_in_smem(height: int, width: int, moves: bool, alphabet: int) -> bool:
    """gotoh_tile_launch's rule: edges, staged codes, the table and the
    warps' profiles within the shared memory a block may opt in to."""
    c = _constants("gotoh_tile")
    edges = c["WARPS"] * (height + 1) * 16
    stage = c["WARPS"] * height * _slot_bytes(2 if width == 2 else 4) if moves else 0
    lookups = ((alphabet * alphabet + 3) // 4 * 4
               + c["WARPS"] * alphabet * c["WARP"] * width) * 4
    return edges + stage + lookups <= fill_batch.SMEM_OPTIN


def _fill_table_in_smem(width: int, warps: int, moves: bool, alphabet: int) -> bool:
    """gotoh_fill's launch rule: its barriers, edge rings, staged codes and
    the table within the shared memory a block may opt in to."""
    c = _constants("gotoh_fill")
    barriers = 2 * c["MAX_WARPS"] * (c["RING"] // c["CH"] * 8 + 4)
    rings = warps * c["RING"] * 16
    stage = warps * 32 * _slot_bytes(width) if moves else 0
    return (barriers + rings + stage + 4 * alphabet * alphabet
            <= fill_batch.SMEM_OPTIN)


def test_table_rules_reach_global_memory():
    """Both rules send a 400-letter table to global memory and keep the
    cells' tables in shared memory."""
    for alphabet, fits in [(DNA_TABLE, True), (400, False)]:
        assert _tile_table_in_smem(64, 4, True, alphabet) is fits
        assert _fill_table_in_smem(16, 8, True, alphabet) is fits


@functools.cache
def _pool(mix: str, letters: str) -> list:
    """The calls of a cell's traffic file at seed 7."""
    spec = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    return traffic.generate(spec, letters, 7)


def _buckets(call):
    """align_pairs' buckets of a call: (M, N) -> (m_true list, n_true list)."""
    out = {}
    for a, b in call:
        key = (bucket_length(len(a)), bucket_length(len(b)))
        out.setdefault(key, ([], []))
        out[key][0].append(len(a))
        out[key][1].append(len(b))
    return out


# -- dna.pair_align: one 10 000 nt pair a request ---------------------------


def _pair_plan(m: int, n: int):
    """A request's kernels past the moves budget: the checkpoint pass's
    (H, W) (cost only) and each replay block's (route, (H, W)) with codes."""
    bounds = linear_tb.block_bounds(m, n,
                                    block_moves_bytes=DEFAULT_MOVES_BUDGET_BYTES)
    checkpoints = fill_tile.plan([(m, n)], False, SMS)
    replays = [(fill_tile.route(1, i1 - i0, n, True, SMS),
                fill_tile.plan([(i1 - i0, n)], True, SMS))
               for i0, i1 in zip(bounds, bounds[1:])]
    return bounds, checkpoints, replays


@pytest.mark.parametrize("part,instance", [
    ("checkpoints", "gotoh_tile_kernel<64,4,false,true>"),
    ("first replay", "gotoh_tile_kernel<64,4,true,true>"),
    ("second replay", "gotoh_tile_kernel<32,4,true,true>"),
])
def test_pair_align_is_blocked_on_gotoh_tile(part, instance):
    """Every request of the first 64 passes the 64 MiB moves budget, so it
    is blocked: two blocks (``block_bounds``), the checkpoint pass one
    cost-only gotoh_tile launch at (64, 4), and each replay routed to
    gotoh_tile (``fill_tile.route``), the first at (64, 4), the second at
    (32, 4), every table in shared memory."""
    height, width, moves, tsmem = _instance(instance)
    assert moves is (part != "checkpoints")
    assert tsmem is _tile_table_in_smem(height, width, moves, DNA_TABLE)
    for (s1, s2), in _pool("wfa_10k_pair", "ACGT")[:64]:
        m, n = len(s1), len(s2)
        assert (m + 1) * (n + 1) > DEFAULT_MOVES_BUDGET_BYTES
        bounds, checkpoints, replays = _pair_plan(m, n)
        assert len(bounds) == 3
        if part == "checkpoints":
            assert checkpoints == (height, width)
        else:
            routed, shape = replays[part == "second replay"]
            assert routed and shape == (height, width)


# -- protein.batch_cost: 1024 BLOSUM62 pairs a call, cost only --------------


PROTEIN = "ARNDCQEGHILKMFPSTWYV"
PROTEIN_TABLE = len(resolve_scheme(PROTEIN, PROTEIN,
                                   scoring_mat_name="BLOSUM62").costing.values)


def _protein_calls(count: int = 4):
    return _pool("protein_rv12_cost", PROTEIN)[:count]


@pytest.mark.parametrize("width", fill_batch.WIDTHS)
def test_protein_call_fills_every_width_class_on_gotoh_batch(width):
    """Every bucket of up to 1024 columns has a ``fill_batch.plan`` width
    class (the table fits in shared memory), and every call holds each of
    the four: one ``gotoh_batch_kernel<W,false,...>`` launch a class."""
    for call in _protein_calls():
        classes = {fill_batch.plan(n_cols, PROTEIN_TABLE)
                   for _, n_cols in _buckets(call)
                   if n_cols <= fill_batch.MAX_COLUMNS}
        assert None not in classes and width in classes


def test_protein_wide_buckets_are_one_gotoh_tile_launch():
    """The buckets past 1024 columns all join one launch
    (``fill_tile.route_buckets``) at (64, 4) cost only, the BLOSUM62 table
    in shared memory: ``gotoh_tile_kernel<64,4,false,true>``."""
    height, width, moves, tsmem = _instance("gotoh_tile_kernel<64,4,false,true>")
    assert tsmem is _tile_table_in_smem(height, width, moves, PROTEIN_TABLE)
    for call in _protein_calls():
        wide = [lengths for (_, n_cols), lengths in _buckets(call).items()
                if fill_batch.plan(n_cols, PROTEIN_TABLE) is None]
        assert wide and fill_tile.route_buckets(wide, SMS) == list(range(len(wide)))
        dims = [d for m_true, n_true in wide for d in zip(m_true, n_true)]
        assert fill_tile.plan(dims, False, SMS) == (height, width)


# -- sars2.batch_tb: 16 genomes of 29 903 nt a call, with traceback ---------


def _genome_calls():
    return _pool("sars2_genomes_tb", "ACGT")


@pytest.mark.parametrize("capacity,segments", [
    ("a quarter of the card", 1), ("the moves budget", 16),
])
def test_genome_call_segments(monkeypatch, capacity, segments):
    """No genome passes the 1536 MiB moves budget (none is blocked), and a
    call's 16 genomes (~14.3 GB of codes) are one segment under
    ``_segment_budget``, a quarter of the card, where a segment capped at
    the moves budget holds one genome."""
    monkeypatch.setattr(batch, "_card_memory", lambda index: CARD_MEMORY)
    cap = (batch._segment_budget(torch.device("cuda", 0))
           if capacity == "a quarter of the card"
           else batch.DEVICE_WALK_MOVES_BUDGET)
    for call in _genome_calls():
        buckets = _buckets(call)
        assert all(fill_cuda.ragged_bytes(*key) <= batch.DEVICE_WALK_MOVES_BUDGET
                   for key in buckets)
        assert len(batch._segments(list(buckets.values()), cap)) == segments


@pytest.mark.parametrize("clusters,tail", [(15, 1), (16, 0), (20, 0), (13, 3),
                                           (12, 4), (11, 0)])
def test_genome_segment_is_one_gotoh_fill_launch(clusters, tail):
    """A segment of a call's 16 genomes: no ``gotoh_batch_moves`` launch and
    one ``gotoh_fill`` ragged launch class at W 16, 8 warps, 8 bands and 1
    pass, the table in shared memory: ``gotoh_fill_kernel<16,true,true,
    true>``, of every genome but the ``tail`` its ``clusters`` (as many as
    the card holds at once) leave to a last wave, which one
    ``gotoh_tile`` launch takes, the smallest.  On an H100 the card holds
    15: one genome goes to ``gotoh_tile_kernel<64,4,true,true>``; at 16 or
    20 none (no partial wave); at 13 three and at 12 four (at (128, 4) 4 x
    54 756 tiles are within 528 warps x a path of 467), at 11 none (5 left
    over are not path-bound)."""
    width, moves, tsmem, ragged = _instance("gotoh_fill_kernel<16,true,true,true>")
    height, tile_w, tile_moves, tile_tsmem = _instance(
        "gotoh_tile_kernel<64,4,true,true>")
    assert moves and ragged and tile_moves
    for call in _genome_calls():
        m, n = [len(a) for a, _ in call], [len(b) for _, b in call]
        warp, classes, tiles = fill_cuda.ragged_routes(
            m, n, DNA_TABLE, SMS, lambda lp: clusters)
        assert warp == []
        ((lp, idx),) = classes
        assert tuple(lp) == (width, 8, 8, 1)
        assert tsmem is _fill_table_in_smem(width, lp[1], moves, DNA_TABLE)
        assert len(idx) == 16 - tail
        if not tail:
            assert tiles == []
            assert sorted(np.asarray(idx).tolist()) == list(range(16))
            continue
        ((rest),) = tiles
        assert sorted(np.concatenate([idx, rest]).tolist()) == list(range(16))
        cells = [m[k] * n[k] for k in range(16)]
        assert max(cells[k] for k in rest) <= min(cells[k] for k in idx)
        dims = [(m[k], n[k]) for k in rest]
        assert fill_tile.path_bound(dims, True, SMS)
        if tail == 1:  # the cell's
            assert fill_tile.plan(dims, True, SMS) == (height, tile_w)
        assert tile_tsmem is _tile_table_in_smem(height, tile_w, True, DNA_TABLE)
