#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_smoke.py`` (no
arguments, one card).  It exits non-zero, printing no result, when no CUDA
device is present or the port's package is not beside it, and when any
phase fails:

  0. print the card's name and power limit (nvidia-smi), build the kernels
     from ``globalign_tpu_torch/csrc`` and the probes of
     ``globalign_tpu_torch/utils/peaks.py`` (one nvcc per source, in
     parallel) and print the build time, and ``ptxas -v`` of
     ``gotoh_batch`` (beside its earlier registers), ``gotoh_batch_moves``
     (a spill fails the phase), ``wave_split``, every ``gotoh_fill``
     instance, both ``walk_block`` kernels, every ``gotoh_tile``
     instance and the ``tokenize`` and ``render`` instances (a spill
     in either of the last three fails the phase) (registers, spills,
     occupancy);
  1. kernel vs plain, on the card against the plain versions on the CPU,
     same seeded inputs, tolerance 0 (all integers): ``batch_moves``
     (final3 and every move code) on ``gotoh_fill`` (``fill_tile.route``
     set aside) and on ``gotoh_tile``; ``batch_moves`` and
     ``batch_last_rows`` seeded from a real checkpoint row (``row0`` /
     ``col0y_top``), on both kernels, with replay blocks of 3355 rows;
     ``gotoh_tile`` at every (H, W) at its tile edges (k H +- 1 rows,
     k 32 W +- 1 columns, m or n of 0 and 1, B = 1 and 2), plain and
     injected, codes and cost only, last rows and lists of rows, under
     DNA, BLOSUM62 and the 60-letter alphabet, and the 20 000^2 blocked
     align's checkpoint rows from one launch;
     ``batch_last_rows`` with the default boundary; the same at the launch
     shapes of ``fill_cuda.plan`` (1, 2 and 8 bands a pair, band and pass
     widths +-1, fewer than 32 columns, m_true 0 / 1, ragged batches whose
     pairs get different band counts); ``walk_block`` over the
     same codes; the ragged moves fill (``batch_moves_ragged``:
     ``gotoh_batch_moves`` up to 1024 columns, ``gotoh_fill``'s ragged mode
     past them) and ``walk_block``'s ragged kernel (``walk_ragged``,
     align_pairs' traceback path) on calls mixing both routes (a pair over 8
     bands in two passes, m_true / n_true 0 and 1) under DNA, BLOSUM62 and
     the 60-letter alphabet, with one pair placed past byte 2^31 of a
     2.2 GB buffer (ROADMAP C1), and ``gotoh_batch_moves`` alone at every
     width class and its edges (1 to 1024 columns, m or n of 0 and 1)
     under DNA, BLOSUM62 and a non-ASCII matrix; both walk kernels at the edges of their
     shared-memory tiles (walks leaving a tile through its top,
     its left and its corner, reaching column 0 inside a tile, from row 0
     and column 0, random codes, 3 x 40 000 and 40 000 x 3, m or n of 0
     and 1, n + 1 at every residue mod 16); the split cost; ``gotoh_batch`` (final3
     and last rows) on
     ragged launches of three buckets (every width class, 1 to 1024
     columns, and 1023 / 1024 / 1025, the last past the cap on
     ``gotoh_fill``), m_true in {0, 1, 7, ..., M}, under DNA, BLOSUM62, an
     odd asymmetric scheme and a 60-letter alphabet, and one width class
     at B = 1 and B = 2 x SMs;
     ``gotoh_fill``'s strip mode (``strip_fill_block``) at RB in {1, 3,
     256} x W in {1, 31, 1024, 16 000}, its col0 a real neighbour's edge,
     under the same four schemes (fin and every edge row), and a 256-row
     block 50 000 columns wide beside a neighbour; the wave kernel
     (``fill_wave.wave_frontiers``: all four captured waves at every row,
     and the cost) at (m, n) from (0, 0) to 12 345 x 3000, the tile edges
     of its plan (k H +- 1, k 32 W +- 1) and lopsided pairs, some buffers
     padded, under four uniform schemes; ``batch_final3_dual`` on two sets
     of B in {1, 33, 132} ragged pairs, 1 to 5000 columns (across the
     1024-column cap), DNA, BLOSUM62 and the 60-letter alphabet;
  2. the main paths, with every launch count set to 0 before each and read
     after it: ``find_global_alignment(..., device="cuda")`` on the
     reference goldens and pairs up to the moves budget (one fill and one
     walk each, equal to ``device="cpu"``; the 8000^2 DNA and 1500^2
     BLOSUM62 alignments also equal to the host walk, ``traceback_moves``,
     over their fetched codes, and to the same align on ``gotoh_fill``);
     every non-strip fill counted on ``gotoh_tile`` where
     ``fill_tile.route`` sends it, on its ``gotoh_fill`` wrapper else;
     10 000² and 20 000² DNA and 9000² BLOSUM62
     pairs past the budget (blocked: one checkpoint launch for the pass,
     one replay fill and one walk per block), each equal — strings, cost,
     score, report bytes — to the full-matrix route with the budget raised; a 3000 x 2500
     pair forced into >= 4 blocks, equal to ``device="cpu"``; ``cost`` (the
     split from ``SPLIT_MIN_ROWS`` rows, else the direct fill; one launch)
     on every pair, equal to the direct fill and to the alignment's cost;
     ``align_pairs`` on 1024-pair DNA and BLOSUM62 chunks (lengths
     819-1024), cost-only and traceback, equal pair by pair to the
     single-pair path on the card and, on 32 pairs, to ``device="cpu"``,
     cost-only with one ``gotoh_batch`` launch a width class (one a
     chunk), traceback with one ``gotoh_batch_moves`` launch a width class
     and no ``gotoh_fill`` launch, and one ragged walk a segment (1 + 1 a
     chunk); a lowered moves budget (three or more segments and a blocked
     pair); a call with pairs on both sides of 1024 columns (both routes,
     one walk); a cost-only BLOSUM62 call of the protein mix's lengths,
     its pairs past 1024 columns in one ``gotoh_tile`` launch (the wide
     route; its counters ``wide_launches`` and ``wide_pairs`` in every
     launch design); ``flush=False`` +
     ``resolve()`` (render queued, nothing fetched before ``resolve()``);
     every unsharded call one letters upload, one ``tokenize_ragged``
     launch, one ``render_ragged`` launch a traceback segment and one
     fetch; ``tokenize_ragged`` and ``render_ragged`` against their plain
     versions (run on the card on the same tensors) on both chunks as
     ``align_pairs`` packs them, each chunk's segment rendered from its own
     fill and walk (lines = the numpy route's ``render_many``), a 1024-pair
     chunk under the non-ASCII matrix, and rows and lines past byte 2^31
     of a 2.2 GB arena and a 3.2 GB lines buffer; the
     batch CLI on the card and on the CPU (byte-identical TSVs); the
     parallel layer: on an NCCL world of one, ``align_pairs(mesh=)`` on both
     chunks (= unsharded, same launches) and ``sharded_pair_cost`` on a
     50 000^2 DNA and a 20 000^2 BLOSUM62 pair (= ``cost()``, one strip
     launch a block); on 4 spawned gloo ranks sharing the card, the same
     two pairs (= the world of one), ``align_blocked(mesh=)`` at 20 000^2
     (= the unsharded blocked path, report bytes too) and
     ``align_pairs(mesh=)`` on the DNA chunk, every rank; the batch CLI
     with ``--shard`` and, over 2 gloo processes, ``--distributed`` with
     and without ``--shard`` (outputs merge to the single-process TSV);
     ``wave_split_fill_cost`` at 10 000^2 and 50 000^2 DNA (= ``cost()``,
     one wave_split launch a call) and ``batch_final3_dual`` on the DNA
     chunk's two widest buckets (= ``align_pairs``, one launch); a custom
     matrix over non-ASCII letters (single pairs and ``align_pairs`` in
     both modes = ``device="cpu"``); the reference-layout package
     (``globalign_tpu_torch.compat``) called with no device argument: the
     goldens, a 4472^2 DNA and a 4472 x 4471 BLOSUM62 pair at the
     reference's input limit (= ``device="cpu"`` and ``cost()``, one
     moves launch a pair, end-to-end times), ``start``'s refusal at 4473 x
     4472 beside ``find_global_alignment`` running it, ``globaligner.main``
     (report bytes = the CLI with ``--device cpu``) and ``dp_compat``'s
     interpreted 200^2 fill (= the card's cost); every ``gotoh_fill`` launch of these
     paths tallied by mode and (B, M, N) (the census);
  3. times with CUDA events: ``gotoh_tile`` beside ``gotoh_fill`` in turns
     and the plain row scan on the card (4096², 8000²); end-to-end
     ``align`` split into fill, walk kernel and fetch + render, beside the
     same align on ``gotoh_fill`` and the route the walk kernel replaced
     (the codes to the host and the host walk); blocked
     ``align`` at 10 000² and 20 000² split into checkpoint pass, replay
     fills, walks, fetch and host assembly, beside the full-matrix route,
     the checkpoint pass as one ``gotoh_tile`` launch beside a
     ``gotoh_fill`` launch a block (in turns), a replay block on
     ``gotoh_fill`` and on every (H, W);
     split ``cost`` on both kernels beside the direct cost-only fill, from
     a golden-sized pair up; ``gotoh_tile``'s tile time at every (H, W)
     (a pair one tile column wide) and its crossover sweep against
     ``gotoh_fill`` (B in {1, 2, 8} x 256² .. 8000², 3355 x 20 000 and
     20 000 x 512, codes and cost only), each beside the critical-path
     model (tiles on the path x the tile time); the wide sweep
     (:func:`wide_sweep`: B = 1 .. 64 wide pairs, a bucket each, in one
     ``gotoh_tile`` launch against a launch a bucket); the walk kernel beside the plain walk; ``align_pairs`` at
     64 x 1024², 64 x 4096² and the two chunks, both modes, split into
     device fill and walk and every host phase of ``phase_seconds``;
     ``tokenize_ragged`` and ``render_ragged`` on both chunks beside their
     plain versions on the card and their byte bounds, and the numpy route
     they replaced (``_encode_bucket`` and two uploads a bucket; the tapes
     fetched and ``render_many``) timed in the same call; each traceback
     chunk's one ragged fill and one ragged walk in device time beside
     their bounds and plain versions, the same fill on ``gotoh_fill``'s
     ragged mode, and the per-bucket launches they replace; the moves
     crossover (B in {1, 8, 33, 132, 1024} pairs of 1024^2 and 256^2 on
     both moves kernels) and the mesh path's 8 x 992 x 1024 shard; the chunk's
     one ragged cost call, its largest bucket and the chunk as one padded
     launch beside ``gotoh_fill``'s final3 mode and the bound (device
     time: the host's enqueue hidden behind a sleep kernel); the crossover
     sweep, B in {1, 33, ..., 1024} pairs of 1024^2 and 256^2, both
     kernels; the batch runner over 4 chunks of 1024 pairs; the probes
     (checked against the row scan first): the peak cell rate of a fill's
     arithmetic and the latency of a dependent load from L1, L2 and shared
     memory, from which each kernel's bound is computed (a walk's: its
     code loads from shared memory plus one L2 latency, beside the old
     design's floor, its codes read where they lie: L2 / L1 loads); ``walk_block`` on a traceback bucket of
     the DNA chunk beside its bound; the strip mode on a 256 x 50 000 block
     beside its plain version and its bound; the 50 000^2 cost on a world
     of one beside ``cost()`` and the direct fill; the gloo exchange per
     super-step; ``align_pairs`` on a world of one beside no mesh; the wave
     kernel at 10 000^2 and 50 000^2 beside the row split in turns (wave,
     split, split, wave) and the direct fill, its plain version on the
     card at both shapes, its bound, and the two measured parts of its
     critical path (a tile's time on a pair one tile column wide, and the
     chain of dependent tiles at each shape); the dual launch beside two
     single-set launches (64 x 4096^2 a set, and the DNA chunk's two
     widest buckets) and its plain version;
     ``gotoh_fill`` at each census class (its most launched shape), its
     bound, and launches x (time - bound) for the class.

The last two lines of standard output are JSON: the kernels' record, then
``{"ok": true, "device": {...}}``.  It uses no JAX and no network.

``python3 chip_smoke.py --wide-sweep`` runs the wide sweep alone (one JSON
line of its rows).  ``python3 chip_smoke.py --walk-ab SRC [SRC ...]``
instead times the walk
kernels beside other builds of ``walk_block.cu`` (``walk_ab``): an older
checkout's (``git show <commit>:globalign_tpu_torch/csrc/walk_block.cu``
into ``build/``) or an edited copy.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 20261016
DNA = "ACGT"
PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
# 59 letters that upper-casing keeps, plus the gap: a 60-token alphabet.
WIDE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789!#$%&()*+,./:;<=>?@[]^_"
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


def log(msg: str) -> None:
    print(msg, flush=True)


def random_seq(rng, letters: str, length: int) -> str:
    return "".join(rng.choice(list(letters), length))


def mutate(rng, seq: str, letters: str, identity: float = 0.85) -> str:
    """A relative of ``seq``: substitutions plus short indels, same length."""
    out = []
    p_sub = (1.0 - identity) * 0.6
    p_indel = (1.0 - identity) * 0.2
    for ch in seq:
        r = rng.random()
        if r < p_sub:
            out.append(rng.choice([c for c in letters if c != ch]))
        elif r < p_sub + p_indel:
            continue  # deletion
        elif r < p_sub + 2 * p_indel:
            out.append(ch)
            out.extend(rng.choice(list(letters), int(rng.integers(1, 4))))
        else:
            out.append(ch)
    out = "".join(out)[: len(seq)]
    return out + random_seq(rng, letters, len(seq) - len(out))


def serving_chunk(rng, letters: str, count: int, lo: int, hi: int):
    """``count`` pairs, each length drawn from [lo, hi] on its own (as the
    JAX package's serving measurement draws them), seq_2 a relative of
    seq_1 cut or extended to its length."""
    pairs = []
    for _ in range(count):
        m, n = (int(x) for x in rng.integers(lo, hi + 1, 2))
        s1 = random_seq(rng, letters, m)
        s2 = mutate(rng, s1, letters) + random_seq(rng, letters, max(0, n - m))
        pairs.append((s1, s2[:n]))
    return pairs


def device_ms(fn, reps: int) -> float:
    """Device time a call of ``fn`` (CUDA events), the card held in a sleep
    kernel while the host enqueues the timed calls, so gaps of host work
    between launches do not count."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fill_census(fill_cuda):
    """Tally every gotoh_fill launch on the card by (mode, B, M, N): wraps
    ``fill_cuda._launch``, which each of its three wrappers calls once a
    gotoh_fill launch (fills that ``fill_tile.route`` sends to gotoh_tile
    do not reach it).  Returns the tally, a Counter the caller may clear."""
    tally = collections.Counter()
    real = fill_cuda._launch

    def counted(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
                row0, col0y_top, want_moves, want_last, counter, col0=None):
        if tok_a.device.type == "cuda":
            mode = ("strip" if col0 is not None else "codes" if want_moves
                    else "last rows" if want_last else "final3")
            if col0 is None and (row0 is not None or col0y_top is not None):
                mode += ", injected"
            tally[(mode, tok_a.shape[0], tok_a.shape[1] - 1,
                   tok_b.shape[1] - 1)] += 1
        return real(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
                    row0, col0y_top, want_moves, want_last, counter, col0=col0)

    fill_cuda._launch = counted
    return tally


@contextlib.contextmanager
def gotoh_fill_only(fill_tile):
    """Within: every non-strip fill goes to gotoh_fill (``fill_tile.route``
    says no), to hold and time gotoh_fill where the route would take
    gotoh_tile."""
    real = fill_tile.route
    fill_tile.route = lambda *args: False
    try:
        yield
    finally:
        fill_tile.route = real


def _rank_main(rank, world, store, jobs, queue, backend):
    """One spawned rank (gloo ranks share cuda:0; an NCCL rank takes card
    ``rank``): run ``jobs``
    in order, every rank the same, and put (rank, "ok", answers) or (rank,
    "error", traceback) on ``queue``.  Each job's launches are counted from
    0; the strip exchanges are timed on the host clock."""
    import traceback

    try:
        sys.path.insert(0, str(REPO))
        import torch
        import torch.distributed as dist

        from globalign_tpu_torch import align_pairs, resolve_scheme
        from globalign_tpu_torch.models.gotoh import GotohAligner
        from globalign_tpu_torch.ops import fill_cuda, fill_tile, linear_tb
        from globalign_tpu_torch.parallel import comm, make_pair_mesh, multihost
        from globalign_tpu_torch.parallel import seqpar

        multihost.initialize(store, world, rank, backend=backend)
        mesh = make_pair_mesh()
        shifts = []
        plain_shift = comm.shift

        def timed_shift(*args):
            t0 = time.perf_counter()
            out = plain_shift(*args)
            shifts.append(time.perf_counter() - t0)
            return out

        comm.shift = timed_shift
        census = fill_census(fill_cuda)
        wrappers = (fill_cuda.strip_fill_block, fill_cuda.batch_moves,
                    fill_cuda.batch_last_rows, fill_tile.gotoh_tile,
                    linear_tb.walk_block)
        answers = []
        for kind, job in jobs:
            scheme = resolve_scheme(*job["scheme_seqs"], **job["scheme_kw"])
            aligner = GotohAligner(scheme, device="cuda")
            for fn in wrappers:
                fn.launches = 0
            census.clear()
            shifts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "cost":
                s1, s2 = job["pair"]
                out = seqpar.sharded_pair_cost(
                    mesh, aligner._encode(s1), aligner._encode(s2),
                    aligner.cost_mat, aligner.gap_id, aligner.gap_open,
                ).tolist()
            elif kind == "blocked":
                s1, s2 = job["pair"]
                tb = linear_tb.align_blocked(
                    aligner._encode(s1), aligner._encode(s2), aligner.cost_mat,
                    aligner.gap_id, aligner.gap_open, s1, s2, mesh=mesh,
                )
                out = [tb.cost, tb.seq_1_aligned, tb.middle_part,
                       tb.seq_2_aligned]
            else:
                out = [
                    (r.cost, r.score, r.seq_1_aligned, r.middle_part,
                     r.seq_2_aligned)
                    for r in align_pairs(job["pairs"], scheme=scheme,
                                         with_traceback=job["traceback"],
                                         mesh=mesh)
                ]
            torch.cuda.synchronize()
            answers.append({
                "out": out,
                "seconds": time.perf_counter() - t0,
                "launches": {fn.__name__: fn.launches for fn in wrappers},
                "census": dict(census),
                "shift_s": list(shifts),
            })
        queue.put((rank, "ok", answers))
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        queue.put((rank, "error", traceback.format_exc()))


def spawn_ranks(world: int, jobs, timeout: float, backend: str = "gloo"):
    """Run ``jobs`` on ``world`` spawned ranks (gloo: sharing cuda:0; NCCL:
    one card each); every rank's answers, rank by rank.  A rank that fails or outlives
    ``timeout`` seconds fails the run; no rank outlives this call."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{Path(tmp) / 'store'}"
        procs = [
            ctx.Process(target=_rank_main,
                        args=(rank, world, store, jobs, results, backend))
            for rank in range(world)
        ]
        for proc in procs:
            proc.start()
        answers = {}
        deadline = time.monotonic() + timeout
        try:
            while len(answers) < world:
                try:
                    rank, status, payload = results.get(
                        timeout=max(1.0, deadline - time.monotonic())
                    )
                except queue_mod.Empty:
                    raise SystemExit(f"phase 2 failed: gloo ranks timed out "
                                     f"after {timeout} s") from None
                if status != "ok":
                    raise SystemExit(f"phase 2 failed: gloo rank {rank}:\n"
                                     f"{payload}")
                answers[rank] = payload
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
    bad = [r for r, proc in enumerate(procs) if proc.exitcode != 0]
    if bad:
        raise SystemExit(f"phase 2 failed: gloo ranks {bad} exited non-zero")
    return [answers[r] for r in range(world)]


def main() -> int:
    if not (REPO / "globalign_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: globalign_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from globalign_tpu_torch import (
        api,
        final_cost_to_score,
        find_global_alignment,
        resolve_scheme,
        validate_and_transform_args,
    )
    from globalign_tpu_torch.models.gotoh import (
        DEFAULT_MOVES_BUDGET_BYTES,
        SPLIT_MIN_ROWS,
        GotohAligner,
    )
    from globalign_tpu_torch import batch as batch_mod
    from globalign_tpu_torch.batch import align_pairs, bucket_length
    from globalign_tpu_torch.ops import (
        fill_batch,
        fill_cuda,
        fill_rows,
        fill_split,
        fill_tile,
        fill_wave,
        linear_tb,
        packed,
    )
    import torch.distributed as dist

    from globalign_tpu_torch.ops.fill_scan import BIG, default_boundary
    from globalign_tpu_torch.ops.traceback import traceback_moves
    from globalign_tpu_torch.runner import BatchRunner
    from globalign_tpu_torch.utils import cuda_build, peaks
    from globalign_tpu_torch.utils.tokenize import encode_padded

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # -- phase 0: card and build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = f"({smi})"
    t0 = time.perf_counter()
    # Registers, spills and stack of each kernel instance (ptxas -v) of
    # gotoh_batch, wave_split and gotoh_fill, compiled in parallel with the
    # build.
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = {
        stem: subprocess.Popen(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
             str(cuda_build.BUILD_DIR / f"{stem}-ptxas.cubin"),
             str(cuda_build.CSRC_DIR / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for stem in ("gotoh_batch", "gotoh_batch_moves", "wave_split",
                     "gotoh_fill", "walk_block", "gotoh_tile", "tokenize",
                     "render")
    }
    libs = cuda_build.build(cuda_build.sources() + [peaks.SOURCE])
    cuda_build.load()
    peaks.load()
    log(f"phase 0: built {', '.join(p.name for p in libs)} in "
        f"{time.perf_counter() - t0:.3f} s")

    def ptxas_report(stem):
        """(template arguments or None, registers, spill bytes, stack bytes)
        a kernel instance, and the registers a warp is given (units of 256)."""
        out, _ = ptxas[stem].communicate(timeout=300)
        if ptxas[stem].returncode != 0:
            raise SystemExit(f"phase 0 failed: ptxas -v of {stem}\n{out}")
        for block in out.split("Compiling entry function")[1:]:
            args = re.search(r"kernel(?:I(\w+?)EEv)?", block).group(1)
            regs = int(re.search(r"Used (\d+) registers", block).group(1))
            spills = sum(int(x) for x in re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                block).groups())
            stack = int(re.search(r"(\d+) bytes stack frame", block).group(1))
            yield args, regs, spills, stack, -(-regs * 32 // 256) * 256

    batch_regs = {}  # "W=32" / "W=32 last" -> registers, spill bytes, warps/SM
    for args, regs, spills, _, per_warp in ptxas_report("gotoh_batch"):
        width, last = re.match(r"Li(\d+)ELb([01])", args).groups()
        warps = min(64, 65536 // per_warp) // fill_batch.WARPS * fill_batch.WARPS
        batch_regs[f"W={width}{' last' if last == '1' else ''}"] = dict(
            registers=regs, spill_bytes=spills, warps_per_sm=warps)
    # The cost instances' registers as gotoh_batch.cu's note gives them,
    # from before gotoh_batch_moves existed (a source of its own, so they
    # should hold).
    batch_regs_before = {"W=32": 226, "W=32 last": 242, "W=16": 152,
                         "W=16 last": 141, "W=8": 84, "W=8 last": 96,
                         "W=4": 54, "W=4 last": 64}
    log(f"phase 0: gotoh_batch (ptxas -v, sm_90a): " + "; ".join(
        f"{k}: {v['registers']} registers (before: "
        f"{batch_regs_before.get(k)}), {v['spill_bytes']} spill bytes, "
        f"{v['warps_per_sm']} warps an SM in blocks of {fill_batch.WARPS}"
        for k, v in sorted(batch_regs.items())))
    # gotoh_batch_moves: an instance per W; a spill fails the phase.
    moves_regs = {}
    for args, regs, spills, stack, per_warp in ptxas_report("gotoh_batch_moves"):
        warps = min(64, 65536 // per_warp) // fill_batch.WARPS * fill_batch.WARPS
        width = re.match(r"Li(\d+)", args).group(1)
        moves_regs[f"W={width}"] = dict(
            registers=regs, spill_bytes=spills, stack_bytes=stack,
            warps_per_sm=warps)
    log(f"phase 0: gotoh_batch_moves (ptxas -v, sm_90a): " + "; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes, "
        f"{v['stack_bytes']} stack bytes, {v['warps_per_sm']} warps an SM in "
        f"blocks of {fill_batch.WARPS}" for k, v in sorted(moves_regs.items())))
    if sorted(moves_regs) != sorted(f"W={w}" for w in fill_batch.WIDTHS) or any(
            v["spill_bytes"] for v in moves_regs.values()):
        raise SystemExit("phase 0 failed: gotoh_batch_moves instances or spills")
    # wave_split: one instance, W = 4; blocks of 4 warps, each staging
    # 32 W + 1 edge cells, and the launch keeps one block an SM.
    (_, regs, spills, stack, per_warp), = ptxas_report("wave_split")
    smem_block = 4 * (32 * fill_wave.WIDTH + 1) * fill_wave.EDGE_BYTES
    wave_regs = dict(
        width=fill_wave.WIDTH, registers=regs, spill_bytes=spills,
        stack_bytes=stack, launched_warps_per_sm=4,
        warps_per_sm=4 * min(65536 // (per_warp * 4), 16,
                             232_448 // smem_block))
    log(f"phase 0: wave_split (ptxas -v, sm_90a): W = {fill_wave.WIDTH}: "
        f"{regs} registers, {spills} spill bytes, {stack} stack bytes, "
        f"occupancy {wave_regs['warps_per_sm']} warps an SM (H = 32 W), "
        f"the launch keeps 4")
    # gotoh_fill: an instance per W, codes or not, the table in shared
    # memory or not, and (with codes) the ragged mode or not.
    fill_regs = {}
    for args, regs, spills, _, _ in ptxas_report("gotoh_fill"):
        width, moves, tsmem, ragged = re.match(
            r"Li(\d+)ELb([01])ELb([01])ELb([01])", args).groups()
        key = (f"W={width}{' codes' if moves == '1' else ''}"
               f"{' table in smem' if tsmem == '1' else ''}"
               f"{' ragged' if ragged == '1' else ''}")
        fill_regs[key] = dict(registers=regs, spill_bytes=spills)
    log("phase 0: gotoh_fill (ptxas -v, sm_90a): " + "; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes"
        for k, v in sorted(fill_regs.items())))
    # walk_block: the block and ragged kernels, two warps a block (a walker
    # and a loader), four code tiles in shared memory.
    walk_regs = [dict(registers=regs, spill_bytes=spills, stack_bytes=stack)
                 for _, regs, spills, stack, _ in ptxas_report("walk_block")]
    log("phase 0: walk_block (ptxas -v, sm_90a): " + "; ".join(
        f"{v['registers']} registers, {v['spill_bytes']} spill bytes, "
        f"{v['stack_bytes']} stack bytes" for v in walk_regs))

    # gotoh_tile: an instance per (H, W), codes or not, the table in shared
    # memory or not; blocks of 4 warps, one an SM.  A spill fails the phase.
    tile_regs = {}
    for args, regs, spills, stack, _ in ptxas_report("gotoh_tile"):
        height, width, moves, tsmem = re.match(
            r"Li(\d+)ELi(\d+)ELb([01])ELb([01])", args).groups()
        tile_regs[(f"H={height} W={width}{' codes' if moves == '1' else ''}"
                   f"{' table in smem' if tsmem == '1' else ''}")] = dict(
            registers=regs, spill_bytes=spills, stack_bytes=stack)
    log("phase 0: gotoh_tile (ptxas -v, sm_90a): " + "; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes, "
        f"{v['stack_bytes']} stack bytes" for k, v in sorted(tile_regs.items())))
    if len(tile_regs) != 4 * len(fill_tile.SHAPES) or any(
            v["spill_bytes"] for v in tile_regs.values()):
        raise SystemExit("phase 0 failed: gotoh_tile instances or spills")

    # A call's letters: tokenize (bytes, code points) and render (bytes,
    # code points), an instance each.  A spill fails the phase.
    letters_regs = {}
    for stem in ("tokenize", "render"):
        for args, regs, spills, stack, _ in ptxas_report(stem):
            letters_regs[f"{stem} {args}"] = dict(
                registers=regs, spill_bytes=spills, stack_bytes=stack)
    log("phase 0: tokenize and render (ptxas -v, sm_90a): " + "; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes, "
        f"{v['stack_bytes']} stack bytes" for k, v in sorted(letters_regs.items())))
    if len(letters_regs) != 4 or any(
            v["spill_bytes"] for v in letters_regs.values()):
        raise SystemExit("phase 0 failed: tokenize / render instances or spills")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    counters = {
        "batch_moves": fill_cuda.batch_moves,
        "batch_last_rows": fill_cuda.batch_last_rows,
        "walk_block": linear_tb.walk_block,
        "batch_final3": fill_batch.batch_final3,
        "strip_fill_block": fill_cuda.strip_fill_block,
        "wave_frontiers": fill_wave.wave_frontiers,
        "batch_moves_ragged": fill_cuda.batch_moves_ragged,
        "walk_ragged": linear_tb.walk_ragged,
        "batch_moves_warp": fill_batch.batch_moves_warp,
        "gotoh_tile": fill_tile.gotoh_tile,
        "tokenize_ragged": packed.tokenize_ragged,
        "render_ragged": packed.render_ragged,
    }
    # Copies counted beside the launches: an unsharded align_pairs call's
    # one letters upload and the batch path's one fetch.
    copies = {"letters_upload": packed.upload, "fetch": batch_mod._to_host}
    # The batch cost fill's wide route: its gotoh_tile launches and the
    # pairs they take.
    wide_counts = ("wide_launches", "wide_pairs")

    # gotoh_fill launches on the main paths by (mode, B, M, N): those
    # between reset_counts() and the read_counts() that add_main() takes.
    census = collections.Counter()
    fill_tally = fill_census(fill_cuda)
    tally_read = collections.Counter()

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for fn in copies.values():
            fn.copies = 0
        for name in wide_counts:
            setattr(fill_batch.batch_final3_ragged, name, 0)
        fill_tally.clear()

    def read_counts():
        tally_read.clear()
        tally_read.update(fill_tally)
        return {**{name: fn.launches for name, fn in counters.items()},
                **{name: fn.copies for name, fn in copies.items()},
                **{name: getattr(fill_batch.batch_final3_ragged, name)
                   for name in wide_counts}}

    def launches(**kw):
        """A launch design: the given counts, 0 for every other wrapper,
        copy and wide-route count."""
        return dict(dict.fromkeys([*counters, *copies, *wide_counts], 0), **kw)

    def design(*fills, **kw):
        """A launch design: ``launches(**kw)`` plus one launch a non-strip
        fill (batch, m, n, with codes, its gotoh_fill wrapper), counted on
        gotoh_tile where ``fill_tile.route`` sends it."""
        out = launches(**kw)
        for batch, m, n, moves, wrapper in fills:
            out["gotoh_tile" if fill_tile.route(batch, m, n, moves, sms)
                else wrapper] += 1
        return out

    def blocked_fills(m, n, budget=DEFAULT_MOVES_BUDGET_BYTES):
        """The replay fills of a blocked align (one a block, B = 1, codes)."""
        bounds = linear_tb.block_bounds(m, n, block_moves_bytes=budget)
        return [(1, i1 - i0, n, True, "batch_moves")
                for i0, i1 in zip(bounds, bounds[1:])]

    main_launches = dict.fromkeys([*counters, *copies, *wide_counts], 0)

    def add_main(counts):
        for name, k in counts.items():
            main_launches[name] += k
        census.update(tally_read)
        tally_read.clear()

    def tokens(scheme, seqs):
        enc = [scheme.alphabet.encode(s) for s in seqs]
        out = np.zeros((len(seqs), max(len(e) for e in enc) + 1), np.int32)
        for b, e in enumerate(enc):
            out[b, 1 : len(e) + 1] = e
        return torch.from_numpy(out)

    def fill_args(scheme, pairs):
        cost = torch.from_numpy(
            np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
        )
        return (
            tokens(scheme, [p[0] for p in pairs]),
            tokens(scheme, [p[1] for p in pairs]),
            cost,
            scheme.alphabet.gap_id,
            scheme.gap_open_cost,
            [len(p[0]) for p in pairs],
            [len(p[1]) for p in pairs],
        )

    def to_dev(args):
        ta, tb, cost, *rest = args
        return (ta.to(dev), tb.to(dev), cost.to(dev), *rest)

    # -- phase 1: kernel vs plain ---------------------------------------
    schemes = {
        "dna": lambda a, b: resolve_scheme(a, b),
        "blosum62": lambda a, b: resolve_scheme(a, b, scoring_mat_name="BLOSUM62"),
        # odd max score: delta_d != delta_i, so dcost != icost
        "odd_asym": lambda a, b: resolve_scheme(
            a, b, match_score=3, mismatch_score=-2, gap_open_score=-5,
            gap_extension_score=-1,
        ),
        "wide60": lambda a, b: resolve_scheme(a, b, gap_open_cost=3),
        # three non-ASCII letters and A (written below)
        "unicode": lambda a, b: resolve_scheme(a, b, scoring_mat_path=uni_path),
    }
    uni_letters = "ΩЖ字A"  # Omega, Zhe, a CJK letter, A
    uni_mtx = (
        f"{' '.join(uni_letters)} -\n"
        + "".join(
            f"{a} " + " ".join(str(4 if a == b else -2) for b in uni_letters)
            + " -3\n" for a in uni_letters
        )
        + "- " + " ".join("-3" for _ in uni_letters) + " 4\n"
    )
    uni_dir = tempfile.TemporaryDirectory()
    uni_path = Path(uni_dir.name) / "unicode.mtx"
    uni_path.write_text(uni_mtx, encoding="utf-8")
    cases = [
        ("dna", DNA, [(1, 1)]),
        ("dna", DNA, [(1, 500)]),
        ("dna", DNA, [(500, 1)]),
        ("dna", DNA, [(37, 129)]),
        ("dna", DNA, [(1000, 1000)]),
        ("blosum62", PROTEIN, [(700, 900)]),
        ("odd_asym", DNA, [(300, 417)]),
        ("wide60", WIDE, [(256, 300)]),
        ("dna", DNA, [(50, 70), (64, 3), (9, 128)]),  # ragged batch of 3
        ("dna", DNA, [(4096, 4096)]),
        ("dna", DNA, [(8000, 8000)]),
    ]

    def abs_err(got, want):
        """Max |got - want| over integer tensors (got on the card)."""
        return int((got.cpu().long() - want.long()).abs().max())

    def make_pairs(name, letters, shapes):
        pairs = [
            (random_seq(rng, letters, m), random_seq(rng, letters, n))
            for m, n in shapes
        ]
        if name == "wide60":  # every letter present: alphabet of 60
            pairs[0] = (letters + pairs[0][0][len(letters):], pairs[0][1])
        scheme = schemes[name](*("".join(s) for s in zip(*pairs)))
        if name == "wide60" and scheme.alphabet.size != 60:
            raise SystemExit(f"wide60 alphabet has {scheme.alphabet.size}")
        return fill_args(scheme, pairs)

    # Each case on gotoh_fill (the route set aside) and on gotoh_tile at its
    # plan's tile shape, both against the one plain fill.
    max_abs_err = tile_err = 0
    for name, letters, shapes in cases:
        args = make_pairs(name, letters, shapes)
        want3, want_mv = fill_cuda.batch_moves(*args)
        with gotoh_fill_only(fill_tile):
            got3, got_mv = fill_cuda.batch_moves(*to_dev(args))
            got3c, no_mv = fill_cuda.batch_moves(*to_dev(args), want_moves=False)
        got3 = got3.cpu()
        got_mv = got_mv.cpu()
        torch.cuda.synchronize()
        err = max(abs_err(got3, want3), abs_err(got_mv, want_mv))
        max_abs_err = max(max_abs_err, err)
        bad = int((got_mv != want_mv).sum())
        t3, t_mv, _ = fill_tile.gotoh_tile(*to_dev(args))
        t3c, _, _ = fill_tile.gotoh_tile(*to_dev(args), want_moves=False)
        terr = max(abs_err(t3, want3), abs_err(t_mv, want_mv),
                   abs_err(t3c, want3))
        tile_err = max(tile_err, terr)
        log(f"phase 1: {name} {shapes}: final3 {got3.tolist()[:1]} "
            f"code mismatches {bad}, max abs err {err}; gotoh_tile "
            f"(H, W) = {fill_tile.plan(shapes, True, sms)}"
            f" max abs err {terr}")
        if err != 0 or terr != 0:
            raise SystemExit(f"phase 1 failed: {name} {shapes}")
        # cost-only mode gives the same final3
        if no_mv is not None or not torch.equal(got3c.cpu(), want3):
            raise SystemExit(f"phase 1 failed (cost mode): {name} {shapes}")

    # Injection: cut each pair at row i0; the plain fill's last row i0 and
    # Iy(i0, 0) seed the rows below, on the card and on the CPU.
    inj_cases = [
        ("dna", DNA, [(4096, 4096)], [2048]),
        # the main path's widths: a short block below row 1000 of a
        # 10 000-column pair, of a 20 000-column pair (the replay block's
        # width: W = 16 over 8 bands of 5 warps), of a 9000-column
        # BLOSUM62 pair, and a ragged batch of 12 500-20 000 columns
        ("dna", DNA, [(1300, 10_000)], [1000]),
        ("dna", DNA, [(1300, 20_000)], [1000]),
        ("blosum62", PROTEIN, [(1300, 9_000)], [1000]),
        ("dna", DNA, [(300, 20_000), (1256, 19_000), (70, 12_500)],
         [44, 1000, 6]),
        ("dna", DNA, [(1000, 1000)], [999]),  # a one-row block
        ("dna", DNA, [(1, 500)], [0]),
        ("blosum62", PROTEIN, [(700, 900)], [301]),
        ("odd_asym", DNA, [(300, 417)], [150]),
        ("wide60", WIDE, [(256, 300)], [100]),
        ("dna", DNA, [(50, 70), (64, 3), (9, 128)], [20, 63, 0]),
        # replay blocks of 3355 rows (the 20 000^2 blocked align's) below
        # row 1000 of a 10 000- and a 20 000-column pair
        ("dna", DNA, [(4355, 10_000)], [1000]),
        ("dna", DNA, [(4355, 20_000)], [1000]),
    ]
    walk_codes = {}  # columns -> (codes, final3) of an injected block
    for name, letters, shapes, cuts in inj_cases:
        ta, tb, cost, gid, go, mt, nt = make_pairs(name, letters, shapes)
        top = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, cuts, nt)
        blk = torch.zeros_like(ta)
        c0 = torch.empty(len(mt), dtype=torch.int32)
        for b, i0 in enumerate(cuts):
            blk[b, 1 : mt[b] - i0 + 1] = ta[b, i0 + 1 : mt[b] + 1]
            c0[b] = go if i0 == 0 else int(top[b, 2, 0])
        rows = [m - i0 for m, i0 in zip(mt, cuts)]
        args = (blk, tb, cost, gid, go, rows, nt)
        inj = dict(row0=top, col0y_top=c0)
        dev_inj = dict(row0=top.to(dev), col0y_top=c0.to(dev))
        want3, want_mv = fill_cuda.batch_moves(*args, **inj)
        want_last = fill_cuda.batch_last_rows(*args, **inj)
        want_def = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, mt, nt)
        with gotoh_fill_only(fill_tile):
            got3, got_mv = fill_cuda.batch_moves(*to_dev(args), **dev_inj)
            got_last = fill_cuda.batch_last_rows(*to_dev(args), **dev_inj)
            got_def = fill_cuda.batch_last_rows(
                *to_dev((ta, tb, cost, gid, go, mt, nt))
            )
        torch.cuda.synchronize()
        err = max(abs_err(got3, want3), abs_err(got_mv, want_mv),
                  abs_err(got_last, want_last), abs_err(got_def, want_def))
        max_abs_err = max(max_abs_err, err)
        # gotoh_tile: the injected codes and last rows, the default last rows
        t3, t_mv, t_last = fill_tile.gotoh_tile(
            *to_dev(args), rows=[[r] for r in rows], **dev_inj)
        _, _, t_def = fill_tile.gotoh_tile(
            *to_dev((ta, tb, cost, gid, go, mt, nt)), want_moves=False,
            rows=[[m] for m in mt])
        terr = max(abs_err(t3, want3), abs_err(t_mv, want_mv),
                   abs_err(t_last[:, 0], want_last), abs_err(t_def[:, 0], want_def))
        tile_err = max(tile_err, terr)
        log(f"phase 1: injected {name} {shapes} cut at {cuts}: codes, final3, "
            f"last rows (injected and default) max abs err {err}; gotoh_tile "
            f"{terr}")
        if err != 0 or terr != 0:
            raise SystemExit(f"phase 1 failed (injection): {name} {shapes}")
        if len(shapes) == 1 and shapes[0][1] in (4096, 20_000) and (
                shapes[0][1] not in walk_codes):
            walk_codes[shapes[0][1]] = (got_mv, got3)

    # The launch shapes of gotoh_fill's plan (ops/fill_cuda.plan) against
    # the plain version: one, two and the most bands a pair gets, band and
    # pass widths +-1 (a pass is one cluster's columns: 32 768 with codes,
    # 65 536 without), fewer than 32 columns, one column, m_true 0 and 1,
    # and ragged batches whose pairs get different band counts.  Codes,
    # final3, the default last rows, and the codes and last rows of the
    # block below row m // 2 injected from the plain fill, tolerance 0.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dna_fill = schemes["dna"](DNA, DNA)
    band_cases = [
        [(40, 100)], [(40, 256)], [(300, 8000)],  # 1, 2 and 8 bands
        [(30, 127)], [(30, 128)], [(30, 129)],
        [(30, 1023)], [(30, 1024)], [(30, 1025)],
        [(20, 2047)], [(20, 2048)], [(20, 2049)],
        [(20, 8191)], [(20, 8192)], [(20, 8193)],
        [(5, 32_767)], [(5, 32_768)], [(5, 32_769)],
        [(3, 65_535)], [(3, 65_536)], [(3, 65_537)],
        [(1, 1)], [(0, 1)], [(1, 0)], [(0, 0)], [(7, 5)], [(0, 31)],
        [(1, 31)], [(33, 31)],
        [(300, 8000), (0, 300), (1, 33), (64, 1)],
        [(100, 4096), (100, 1), (7, 2049), (0, 0), (50, 700)],
    ]
    band_err = 0
    for shapes in band_cases:
        pairs = [(random_seq(rng, DNA, m), random_seq(rng, DNA, n))
                 for m, n in shapes]
        ta, tb, cost, gid, go, mt, nt = args = fill_args(dna_fill, pairs)
        cuts = [m // 2 for m in mt]
        top = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, cuts, nt)
        blk = torch.zeros_like(ta)
        c0 = torch.empty(len(mt), dtype=torch.int32)
        for b, i0 in enumerate(cuts):
            blk[b, 1 : mt[b] - i0 + 1] = ta[b, i0 + 1 : mt[b] + 1]
            c0[b] = go if i0 == 0 else int(top[b, 2, 0])
        inj_args = (blk, tb, cost, gid, go, [m - i0 for m, i0 in zip(mt, cuts)], nt)
        inj = dict(row0=top, col0y_top=c0)
        dev_inj = dict(row0=top.to(dev), col0y_top=c0.to(dev))
        calls = [
            (lambda a, **k: fill_cuda.batch_moves(*a, **k), args, {}, {}),
            (lambda a, **k: fill_cuda.batch_moves(*a, want_moves=False, **k)[0],
             args, {}, {}),
            (lambda a, **k: fill_cuda.batch_last_rows(*a, **k), args, {}, {}),
            (lambda a, **k: fill_cuda.batch_moves(*a, **k), inj_args, inj,
             dev_inj),
            (lambda a, **k: fill_cuda.batch_last_rows(*a, **k), inj_args, inj, dev_inj),
        ]
        for fn, a, kw_cpu, kw_dev in calls:
            want = fn(a, **kw_cpu)
            with gotoh_fill_only(fill_tile):  # gotoh_fill's own plan shapes
                got = fn(to_dev(a), **kw_dev)
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            err = max(abs_err(g, w) for g, w in zip(got, want))
            band_err = max(band_err, err)
            if err != 0:
                raise SystemExit(f"phase 1 failed: gotoh_fill plan shapes {shapes}")
        plans = {
            mode: fill_cuda.plan(len(mt), max(nt), mode == "codes", sms)
            for mode in ("codes", "cost")
        }
        bands = [
            -(-(-(-max(n, 1) // (32 * plans["cost"].width))) // plans["cost"].warps)
            for n in nt
        ]
        log(f"phase 1: gotoh_fill plan shapes (m, n) {shapes}: plans "
            f"{ {k: tuple(v) for k, v in plans.items()} } (W, warps, bands, "
            f"passes), cost-only bands a pair {bands}; codes, final3, last "
            f"rows, injected codes and last rows max abs err 0")
    max_abs_err = max(max_abs_err, band_err)

    # gotoh_tile against its plain version (the row scan; the rows block by
    # block between them), tolerance 0: every (H, W) instance at its tile
    # edges (k H +- 1 rows, k 32 W +- 1 columns, m or n of 0 and 1, two
    # pairs of other shapes in one launch), with codes and cost only, plain
    # and injected below row m // 2, the last row and (one pair) a list of
    # rows around the tile rows, under DNA, BLOSUM62 and the 60-letter
    # alphabet; then the 20 000^2 blocked align's checkpoint rows.
    def tile_check(args, shape, rows, inj=None):
        inj = inj or {}
        dev_inj = {k: v.to(dev) for k, v in inj.items()}
        err = 0
        for want_moves in (True, False):
            want = fill_tile.gotoh_tile(*args, want_moves=want_moves, rows=rows,
                                        **inj)
            before = fill_tile.gotoh_tile.launches
            got = fill_tile.gotoh_tile(*to_dev(args), want_moves=want_moves,
                                       rows=rows, shape=shape, **dev_inj)
            torch.cuda.synchronize()
            if fill_tile.gotoh_tile.launches != before + 1:
                raise SystemExit("phase 1 failed: gotoh_tile not one launch")
            for g, w in zip(got, want):
                if (g is None) != (w is None):
                    raise SystemExit("phase 1 failed: gotoh_tile outputs")
                if w is not None:
                    err = max(err, abs_err(g, w))
        return err

    for height, width in fill_tile.SHAPES:
        cols = 32 * width
        edge_shapes = [
            [(height - 1, cols - 1)], [(height, cols)], [(height + 1, cols + 1)],
            [(2 * height + 1, 3 * cols - 1)], [(3 * height - 1, 2 * cols + 1)],
            [(1, 1)], [(1, 3 * cols + 1)], [(3 * height + 1, 1)], [(0, 5)],
            [(5, 0)], [(0, 0)],
            [(2 * height + 1, cols + 1), (height - 1, 2 * cols + 3)],
        ]
        runs_tile = [("dna", DNA, sh) for sh in edge_shapes] + [
            ("blosum62", PROTEIN, sh) for sh in edge_shapes[:5] + edge_shapes[-1:]
        ] + [("wide60", WIDE, [(2 * height + 1, 3 * cols - 1)])]
        for name, letters, shapes in runs_tile:
            pairs = [(random_seq(rng, letters, m), random_seq(rng, letters, n))
                     for m, n in shapes]
            ta, tb, cost, gid, go, mt, nt = args = fill_args(
                schemes[name](letters, letters), pairs)
            rows = [[m] for m in mt]
            if len(mt) == 1 and mt[0] > height + 1:
                rows = [[1, height - 1, height, height + 1, mt[0]]]
            err = tile_check(args, (height, width), rows)
            cuts = [m // 2 for m in mt]
            top = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, cuts, nt)
            blk = torch.zeros_like(ta)
            c0 = torch.empty(len(mt), dtype=torch.int32)
            for b, i0 in enumerate(cuts):
                blk[b, 1 : mt[b] - i0 + 1] = ta[b, i0 + 1 : mt[b] + 1]
                c0[b] = go if i0 == 0 else int(top[b, 2, 0])
            rest = [m - i0 for m, i0 in zip(mt, cuts)]
            err = max(err, tile_check((blk, tb, cost, gid, go, rest, nt),
                                      (height, width), [[r] for r in rest],
                                      dict(row0=top, col0y_top=c0)))
            tile_err = max(tile_err, err)
            if err != 0:
                raise SystemExit(f"phase 1 failed: gotoh_tile H={height} "
                                 f"W={width} {name} {shapes}")
        log(f"phase 1: gotoh_tile H={height} W={width} at its tile edges "
            f"({len(runs_tile)} calls: DNA, BLOSUM62, wide60; B = 1 and 2; "
            f"plain and injected; codes and cost only; last rows and a list "
            f"of rows): max abs err 0")

    # The 20 000^2 blocked align's checkpoint rows from one launch at every
    # (H, W), against the row scan block by block.
    s1 = random_seq(rng, DNA, 20_000)
    ck_args = fill_args(schemes["dna"](DNA, DNA), [(s1, mutate(rng, s1, DNA))])
    ck_rows = linear_tb.block_bounds(
        ck_args[5][0], ck_args[6][0],
        block_moves_bytes=DEFAULT_MOVES_BUDGET_BYTES)[1:]
    t0 = time.perf_counter()
    want_ck = fill_tile.checkpoint_rows(ck_args[0][0], ck_args[1][0],
                                        *ck_args[2:5], ck_rows)
    ck_plain_s = time.perf_counter() - t0
    ck_err = 0
    for shape in fill_tile.SHAPES:
        _, _, got_ck = fill_tile.gotoh_tile(*to_dev(ck_args), want_moves=False,
                                            rows=[ck_rows], shape=shape)
        ck_err = max(ck_err, abs_err(got_ck[0], want_ck))
    tile_err = max(tile_err, ck_err)
    log(f"phase 1: gotoh_tile checkpoint rows {ck_rows} of a 20000^2 DNA pair "
        f"at every (H, W), one launch each: max abs err {ck_err} (the row "
        f"scan block by block on the host: {ck_plain_s:.3f} s)")
    if ck_err != 0:
        raise SystemExit("phase 1 failed: gotoh_tile checkpoint rows 20000^2")

    # The walk over the injected 4096- and 20 000-column blocks' codes,
    # from the block's corner and from inside it.
    walk_err = 0
    for walk_moves, walk_final3 in walk_codes.values():
        k_rows = walk_moves.shape[1] - 1
        n_cols = walk_moves.shape[2] - 1
        for i_entry, j_entry in (([k_rows], [n_cols]), ([k_rows // 3], [17])):
            level = walk_final3.argmin(-1).to(torch.int32)
            j_dev = torch.tensor(j_entry, dtype=torch.int32, device=dev)
            want = linear_tb.walk_block(walk_moves.cpu(), i_entry,
                                        j_dev.cpu(), level.cpu())
            got = linear_tb.walk_block(walk_moves, i_entry, j_dev, level)
            torch.cuda.synchronize()
            err = max(abs_err(g, w) for g, w in zip(got, want))
            walk_err = max(walk_err, err)
            log(f"phase 1: walk_block {k_rows} x {n_cols} from "
                f"({i_entry[0]}, {j_entry[0]}): {int(got[1][0])} steps, max "
                f"abs err {err}")
    if walk_err != 0:
        raise SystemExit("phase 1 failed: walk_block != plain walk")

    # The ragged moves fill (gotoh_batch_moves up to 1024 columns,
    # gotoh_fill's ragged mode past them) and walk_block's ragged kernel (the
    # traceback path of align_pairs) against their plain versions, the row
    # scan and the walk pair by pair through the same buffer: each call
    # mixes both routes, its gotoh_fill pairs in several launch classes (a
    # pair over 8 bands in two passes, pairs over several bands and over
    # one), m_true / n_true 0 and 1; final3, every byte of each pair's rows,
    # tapes, counts and exit columns, tolerance 0; one launch a width class
    # or launch class, one walk launch.
    def ragged_err(got, want):
        err = abs_err(got.final3, want.final3)
        for row in want.layout.tolist():
            lo, hi = row[4], row[4] + (row[2] + 1) * row[5]
            err = max(err, abs_err(got.codes[lo:hi], want.codes[lo:hi]))
        return err

    ragged_sets = [
        ("dna", DNA, [[(40, 33_000), (3, 5000)], [(1, 1), (0, 7), (9, 0), (1, 300)],
                      [(200, 300), (300, 1), (250, 290)],
                      [(64, 2100), (1000, 1000)]]),
        ("blosum62", PROTEIN, [[(700, 900), (1, 1)], [(30, 4096), (90, 33)]]),
        ("wide60", WIDE, [[(256, 300), (1, 2)], [(5, 1030)]]),
    ]
    fill_ragged_err = walk_ragged_err = 0
    for name, letters, buckets in ragged_sets:
        scheme = schemes[name](letters, letters)
        made = [fill_args(scheme, [(random_seq(rng, letters, m),
                                    random_seq(rng, letters, n))
                                   for m, n in shapes]) for shapes in buckets]
        args = ([x[0] for x in made], [x[1] for x in made], *made[0][2:5],
                [x[5] for x in made], [x[6] for x in made])
        on_card = ([t.to(dev) for t in args[0]], [t.to(dev) for t in args[1]],
                   args[2].to(dev), *args[3:])
        want = fill_cuda.batch_moves_ragged(*args)
        want_walk = linear_tb.walk_ragged(want)
        warp, classes = fill_cuda.ragged_routes(
            [m for x in made for m in x[5]], [n for x in made for n in x[6]],
            args[2].shape[0], sms)
        ragged_counters = (fill_batch.batch_moves_warp,
                           fill_cuda.batch_moves_ragged, linear_tb.walk_ragged)
        before = [fn.launches for fn in ragged_counters]
        got = fill_cuda.batch_moves_ragged(*on_card)
        got_walk = linear_tb.walk_ragged(got)
        torch.cuda.synchronize()
        ran = tuple(fn.launches - k for fn, k in zip(ragged_counters, before))
        err = ragged_err(got, want)
        werr = max(abs_err(g, w) for g, w in zip(got_walk, want_walk))
        fill_ragged_err = max(fill_ragged_err, err)
        walk_ragged_err = max(walk_ragged_err, werr)
        log(f"phase 1: ragged fill and walk {name}, buckets {buckets}: "
            f"gotoh_batch_moves widths {[(w, len(i)) for w, i in warp]}, "
            f"gotoh_fill launch classes "
            f"{[(tuple(lp), len(i)) for lp, i in classes]} (W, warps, bands, "
            f"passes); launches (gotoh_batch_moves, gotoh_fill ragged, walk) "
            f"{ran}; final3 and codes max abs err {err}, tapes, counts, exit "
            f"columns max abs err {werr}")
        if err or werr or ran != (len(warp), len(classes), 1) or not (
                warp and classes):
            raise SystemExit(f"phase 1 failed: ragged fill / walk {name}")
    # ROADMAP C1: a pair placed past byte 2^31 of a 2.2 GB buffer, where the
    # JAX mega-walk's int32 offsets wrap; the first pair at byte 16 (offsets
    # are multiples of 16); both on gotoh_batch_moves.
    scheme = schemes["dna"](DNA, DNA)
    made = fill_args(scheme, [(random_seq(rng, DNA, m), random_seq(rng, DNA, n))
                              for m, n in ((700, 650), (1000, 1000))])
    place = dict(offsets=[16, 2**31 + 4096], nbytes=2_200_000_000)
    before = fill_batch.batch_moves_warp.launches
    args = ([made[0]], [made[1]], *made[2:5], [made[5]], [made[6]])
    want = fill_cuda.batch_moves_ragged(*args, **place)
    got = fill_cuda.batch_moves_ragged(
        [made[0].to(dev)], [made[1].to(dev)], made[2].to(dev), *args[3:], **place)
    got_walk = linear_tb.walk_ragged(got)
    torch.cuda.synchronize()
    err = ragged_err(got, want)
    werr = max(abs_err(g, w) for g, w in zip(got_walk, linear_tb.walk_ragged(want)))
    fill_ragged_err = max(fill_ragged_err, err)
    walk_ragged_err = max(walk_ragged_err, werr)
    ran = fill_batch.batch_moves_warp.launches - before
    log(f"phase 1: ragged fill and walk with a pair at byte "
        f"{int(got.layout[:, 4].max())} of a {place['nbytes']}-byte buffer "
        f"(past 2^31 = {2**31}), {ran} gotoh_batch_moves launch: final3 and "
        f"codes max abs err {err}, tapes, counts, exit columns max abs err "
        f"{werr}")
    if err or werr or int(got.layout[:, 4].max()) <= 2**31 or ran != 1:
        raise SystemExit("phase 1 failed: ragged fill / walk past byte 2^31")
    del want, got, got_walk

    # gotoh_batch_moves alone against the plain row scan, tolerance 0:
    # every width class and its edges (1, 31-33, 127-129, 255-257, 511-513,
    # 1023 and 1024 columns), m or n of 0 and 1, three buckets, under DNA,
    # BLOSUM62 and the non-ASCII matrix: final3 and every byte of each
    # pair's rows (row 0, column 0, the bytes past n), one launch a width
    # class and no gotoh_fill launch; the ragged walk over its codes = the
    # plain walk over the plain codes.
    warp_shapes = [
        (37, 1), (1, 31), (40, 32), (33, 33), (0, 5), (5, 0), (0, 0), (1, 1),
        (90, 127), (2, 128), (129, 129), (60, 255), (256, 256), (17, 257),
        (11, 511), (300, 512), (9, 513), (45, 1023), (1024, 1024), (1, 1024),
        (1024, 1)]
    warp_err = 0
    for name, letters in (("dna", DNA), ("blosum62", PROTEIN),
                          ("unicode", uni_letters)):
        scheme = schemes[name](letters, letters)
        order = rng.permutation(len(warp_shapes))
        made = [fill_args(scheme, [(random_seq(rng, letters, m),
                                    random_seq(rng, letters, n))
                                   for m, n in (warp_shapes[k] for k in
                                                order[lo : lo + 7])])
                for lo in (0, 7, 14)]
        args = ([x[0] for x in made], [x[1] for x in made], *made[0][2:5],
                [x[5] for x in made], [x[6] for x in made])
        want = fill_cuda.batch_moves_ragged(*args)
        ragged_counters = (fill_batch.batch_moves_warp,
                           fill_cuda.batch_moves_ragged, linear_tb.walk_ragged)
        before = [fn.launches for fn in ragged_counters]
        got = fill_cuda.batch_moves_ragged(
            [t.to(dev) for t in args[0]], [t.to(dev) for t in args[1]],
            args[2].to(dev), *args[3:])
        got_walk = linear_tb.walk_ragged(got)
        torch.cuda.synchronize()
        ran = tuple(fn.launches - k for fn, k in zip(ragged_counters, before))
        widths = {fill_batch.width_class(n) for _, n in warp_shapes}
        err = max(ragged_err(got, want), max(
            abs_err(g, w) for g, w in zip(got_walk, linear_tb.walk_ragged(want))))
        warp_err = max(warp_err, err)
        log(f"phase 1: gotoh_batch_moves {name}, {len(warp_shapes)} pairs "
            f"{warp_shapes} in 3 buckets: launches (gotoh_batch_moves, "
            f"gotoh_fill ragged, walk) {ran}; final3, codes, tapes, counts and "
            f"exit columns max abs err {err}")
        if err or ran != (len(widths), 0, 1):
            raise SystemExit(f"phase 1 failed: gotoh_batch_moves {name}")
    del want, got, got_walk

    # Both walk kernels at the edges of their code tiles (staged in shared
    # memory; the library reports their shape)
    # against the plain walk, tolerance 0 (ops, counts,
    # exit columns and levels); their own rng, so the other sets' data stays
    # as it was.  walk_block over synthetic codes: a walk straight up (out
    # of each tile through its top), straight left (through its left, to
    # column 0 in the middle of a tile, then up), diagonal through tile
    # corners, random and biased random codes, a walk from row 0 and one
    # from column 0; over real fills: 3 x 40 000 and 40 000 x 3, and n + 1
    # at every residue mod 16.  walk_ragged over those fills' shapes and m
    # or n of 0 and 1 packed in one buffer, with the real codes and with
    # random ones in their place.
    erng = np.random.default_rng(SEED + 11)
    ek, en = 300, 1000
    lv = erng.integers(0, 3, (8, ek + 1, en + 1, 3))
    lv[4, ..., 0] = np.where(erng.random((ek + 1, en + 1)) < 0.8, 0, lv[4, ..., 0])
    lv[4, ..., 1] = np.where(erng.random((ek + 1, en + 1)) < 0.7, 1, lv[4, ..., 1])
    lv[4, ..., 2] = np.where(erng.random((ek + 1, en + 1)) < 0.7, 2, lv[4, ..., 2])
    lv[0], lv[1], lv[2] = 2, 1, 0  # up in Iy, left in Ix, diagonal in M
    synth = torch.from_numpy(
        (lv[..., 0] | lv[..., 1] << 2 | lv[..., 2] << 4).astype(np.uint8))
    edge_i = [ek, 150, 3 * 32 + 5, ek, ek, 0, ek, 33]
    edge_j = torch.tensor([700, en, 2 * 128 + 5, en, en - 1, 500, 0, 129],
                          dtype=torch.int32)
    edge_l = torch.from_numpy(
        np.r_[2, 1, 0, erng.integers(0, 3, 5)].astype(np.int32))
    edge_walks = [(synth, edge_i, edge_j, edge_l)]
    dna_edge = schemes["dna"](DNA, DNA)
    for m, n in [(3, 40_000), (40_000, 3)] + [(45, 15 + k) for k in range(16)]:
        a = fill_args(dna_edge, [(random_seq(erng, DNA, m),
                                  random_seq(erng, DNA, n))])
        f3, mv = fill_cuda.batch_moves(*to_dev(a))
        edge_walks.append((mv.cpu(), [m], torch.tensor([n], dtype=torch.int32),
                           f3.argmin(-1).to(torch.int32).cpu()))
    edge_err = 0
    for mv, i_e, j_e, l_e in edge_walks:
        want = linear_tb.walk_block(mv, i_e, j_e, l_e)
        got = linear_tb.walk_block(mv.to(dev), i_e, j_e.to(dev), l_e.to(dev))
        torch.cuda.synchronize()
        edge_err = max(edge_err, max(abs_err(g, w) for g, w in zip(got, want)))
    walk_err = max(walk_err, edge_err)
    lib = cuda_build.load()
    tile = [lib.walk_tile_rows(), lib.walk_tile_cols()]
    corner = [(i, j) for i, j in zip(range(edge_i[2], -1, -1),
                                     range(int(edge_j[2]), -1, -1))
              if i % tile[0] == 0 and j % tile[1] == 0 and i and j]
    log(f"phase 1: walk_block at the edges of its {tile[0]} x {tile[1]} tiles: "
        f"{len(edge_walks[0][1])} "
        f"synthetic walks over {ek} x {en} codes (up, left to column 0 at row "
        f"150, diagonal through the tile corners {corner[:2]}, random, biased, "
        f"from row 0 and from column 0), 3 x 40000, 40000 x 3 and n + 1 at "
        f"every residue mod 16 ({len(edge_walks) - 1} real fills): ops, "
        f"counts, exit columns and levels max abs err {edge_err}")
    if edge_err != 0 or not corner:
        raise SystemExit("phase 1 failed: walk_block at its tile edges")
    shapes = ([(3, 40_000), (40_000, 3), (0, 5), (5, 0), (1, 1), (0, 0), (1, 0),
               (0, 1), (1, 7), (7, 1)] + [(45, 15 + k) for k in range(16)])
    made = [fill_args(dna_edge, [(random_seq(erng, DNA, m), random_seq(erng, DNA, n))])
            for m, n in shapes]
    args = ([x[0] for x in made], [x[1] for x in made], *made[0][2:5],
            [x[5] for x in made], [x[6] for x in made])
    want = fill_cuda.batch_moves_ragged(*args)
    got = fill_cuda.batch_moves_ragged(
        [t.to(dev) for t in args[0]], [t.to(dev) for t in args[1]],
        args[2].to(dev), *args[3:])
    lv = erng.integers(0, 3, (want.codes.numel(), 3))  # levels 0..2 a field
    noise = torch.from_numpy((lv[:, 0] | lv[:, 1] << 2 | lv[:, 2] << 4).astype(np.uint8))
    edge_err = ragged_err(got, want)
    for host, card_codes in ((want, got.codes), (want._replace(codes=noise),
                                                 noise.to(dev))):
        before = linear_tb.walk_ragged.launches
        got_walk = linear_tb.walk_ragged(got._replace(codes=card_codes))
        torch.cuda.synchronize()
        if linear_tb.walk_ragged.launches != before + 1:
            raise SystemExit("phase 1 failed: walk_ragged launches")
        edge_err = max(edge_err, max(
            abs_err(g, w) for g, w in zip(got_walk, linear_tb.walk_ragged(host))))
    walk_ragged_err = max(walk_ragged_err, edge_err)
    log(f"phase 1: walk_ragged at its tile edges: {len(shapes)} pairs packed "
        f"tight ({shapes[:10]} and n + 1 at every residue mod 16), their codes "
        f"and random codes: final3, codes, tapes, counts and exit columns max "
        f"abs err {edge_err}")
    if edge_err != 0:
        raise SystemExit("phase 1 failed: walk_ragged at its tile edges")
    del want, got, got_walk, synth, edge_walks

    # The split cost on the card against its plain version.
    for name, letters, (m, n) in (("dna", DNA, (2, 0)), ("dna", DNA, (1, 300)),
                                  ("dna", DNA, (2000, 1999)),
                                  ("blosum62", PROTEIN, (701, 900)),
                                  ("dna", DNA, (300, 10_000)),
                                  ("dna", DNA, (3, 20_000)),
                                  ("blosum62", PROTEIN, (301, 9_000))):
        ta, tb, cost, gid, go, _, _ = make_pairs(name, letters, [(m, n)])
        want = fill_split.split_fill_cost(ta[0], tb[0], cost, gid, go)
        got = fill_split.split_fill_cost(
            ta[0].to(dev), tb[0].to(dev), cost.to(dev), gid, go
        )
        err = abs_err(got, want)
        max_abs_err = max(max_abs_err, err)
        log(f"phase 1: split cost {name} {m} x {n}: {int(got)}, max abs err "
            f"{err}")
        if err != 0:
            raise SystemExit(f"phase 1 failed (split): {name} {m} x {n}")

    # gotoh_batch (the batch cost fill) on ragged launches: final3 and the
    # last rows at every column, on the card against the plain version on
    # the CPU.  Each call holds three buckets: one of n_cols columns (m_true
    # 0, 1, 7 and M, partial and zero widths), one of every width class
    # (n < 32 and 33-1024 columns) and one of 1023 / 1024 / 1025 columns,
    # the last past the 1024-column cap (gotoh_fill's final3 / last-row
    # mode, one launch each); gotoh_batch launches once per width class.
    batch_err = 0
    for name, letters in (("dna", DNA), ("blosum62", PROTEIN),
                          ("odd_asym", DNA), ("wide60", WIDE)):
        for n_cols in (1, 31, 33, 255, 1023, fill_batch.MAX_COLUMNS, 1025):
            rows = 300 if n_cols <= 255 else 200
            buckets = [
                [(rows, n_cols), (0, n_cols), (1, n_cols),
                 (rows, max(0, n_cols - 7)), (rows // 2, n_cols // 3),
                 (rows, 0), (7, n_cols), (rows, 1)],
                [(40, 20), (1, 100), (33, 129), (70, 256), (7, 257),
                 (90, 511), (0, 700), (64, 1000)],
                [(50, 1023), (1, 1024), (7, 1024)],
            ]
            scheme = schemes[name](letters, letters)  # one for the launch
            made = [fill_args(scheme, [
                (random_seq(rng, letters, m), random_seq(rng, letters, n))
                for m, n in shapes]) for shapes in buckets]
            cost, gid, go = made[0][2:5]
            args = ([m[0] for m in made], [m[1] for m in made], cost, gid, go,
                    [m[5] for m in made], [m[6] for m in made])
            on_card = ([t.to(dev) for t in args[0]], [t.to(dev) for t in args[1]],
                       cost.to(dev), gid, go, *args[5:])
            want3 = fill_batch.batch_final3_ragged(*args)
            want_last = fill_batch.batch_final3_ragged(*args, last_rows=True)
            classes = {fill_batch.width_class(n) for m in made for n in m[6]
                       if m[1].shape[1] - 1 <= fill_batch.MAX_COLUMNS}
            wide = [(m[5], m[6]) for m in made
                    if m[1].shape[1] - 1 > fill_batch.MAX_COLUMNS]
            tiled = len(fill_tile.route_buckets(wide, sms))  # the wide route
            untiled = len(wide) - tiled
            before = (fill_batch.batch_final3.launches,
                      fill_cuda.batch_moves.launches,
                      fill_cuda.batch_last_rows.launches,
                      fill_batch.batch_final3_ragged.wide_launches)
            got3 = fill_batch.batch_final3_ragged(*on_card)
            got_last = fill_batch.batch_final3_ragged(*on_card, last_rows=True)
            torch.cuda.synchronize()
            after = (fill_batch.batch_final3.launches,
                     fill_cuda.batch_moves.launches,
                     fill_cuda.batch_last_rows.launches,
                     fill_batch.batch_final3_ragged.wide_launches)
            if [a - b for a, b in zip(after, before)] != [
                    2 * len(classes), untiled, untiled, 2 * bool(tiled)]:
                raise SystemExit(f"phase 1 failed: gotoh_batch launches for "
                                 f"{name} N={n_cols}: {before} -> {after}, "
                                 f"{len(classes)} width classes")
            err = max([abs_err(got3, want3)]
                      + [abs_err(g, w) for g, w in zip(got_last, want_last)])
            batch_err = max(batch_err, err)
            log(f"phase 1: gotoh_batch ragged {name}, buckets of N={n_cols}, "
                f"{args[1][1].shape[1] - 1} and {args[1][2].shape[1] - 1} "
                f"({sum(len(m[5]) for m in made)} pairs, width classes "
                f"{sorted(classes)}, {len(wide)} bucket past the cap, {tiled} "
                f"on the wide route's gotoh_tile): final3 and last rows max "
                f"abs err {err}")
    # One width class at a batch of 1 and of 2 x SMs (a lone warp on the
    # card, and two pairs an SM): one launch each, equal to the plain
    # version.
    for nb in (1, 2 * sms):
        args = make_pairs("dna", DNA, [(1024, 1024)] + [(300, 1000)] * (nb - 1))
        want3 = fill_batch.batch_final3(*args)
        before = fill_batch.batch_final3.launches
        got3 = fill_batch.batch_final3(*to_dev(args))
        torch.cuda.synchronize()
        err = abs_err(got3, want3)
        batch_err = max(batch_err, err)
        if fill_batch.batch_final3.launches != before + 1 or err:
            raise SystemExit(f"phase 1 failed: gotoh_batch B={nb}")
        log(f"phase 1: gotoh_batch B={nb} of up to 1024 x 1024: one launch, "
            f"final3 max abs err {err}")
    if batch_err != 0:
        raise SystemExit("phase 1 failed: gotoh_batch != plain version")

    # gotoh_fill's strip mode (TPU kernel #10) against its plain version,
    # the row scan's col0_full / want_edge / want_fin_row modes: a block of
    # RB rows under a real checkpoint row, cut into a strip at the matrix
    # edge and the strip of W columns to its right, whose col0 is the edge
    # the plain fill of the left strip gives.  Both strips, fin and every
    # edge row, m_true short of RB included; W = 16 000 runs 8 columns a
    # lane over 8 bands.
    def strip_case(name, letters, rb, width, left=37, i0=5):
        scheme = schemes[name](letters, letters)
        cost = torch.from_numpy(
            np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
        )
        gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost

        def enc(k):
            return torch.tensor(
                [0, *scheme.alphabet.encode(random_seq(rng, letters, k))],
                dtype=torch.int32,
            )

        ta_full, tb_full = enc(i0 + rb), enc(left + width)
        top = fill_rows.row_fill(ta_full[: i0 + 1], tb_full, cost, gid, go,
                                 want_moves=False).last3
        steps = cost[ta_full[i0:], gid].clone()
        steps[0] = 0
        edge0 = torch.stack(
            [torch.full((rb + 1,), BIG, dtype=torch.int32)] * 2
            + [int(top[2, 0]) + torch.cumsum(steps, 0, dtype=torch.int32)]
        )
        ta = ta_full[i0:].clone()
        ta[0] = 0
        left_args = (ta[None], tb_full[None, : left + 1].contiguous(), cost,
                     gid, go, top[None, :, : left + 1].contiguous(), edge0[None])
        _, edge = fill_cuda.strip_fill_block(*left_args, [rb])
        tb = torch.cat([torch.zeros(1, dtype=torch.int32), tb_full[left + 1 :]])
        right_args = (ta[None], tb[None], cost, gid, go,
                      top[None, :, left:].contiguous(), edge)
        return left_args, right_args

    def strip_on_card(args):
        ta, tb, cost, gid, go, row0, col0 = args
        return (ta.to(dev), tb.to(dev), cost.to(dev), gid, go, row0.to(dev),
                col0.to(dev))

    strip_err = 0
    for name, letters in (("dna", DNA), ("blosum62", PROTEIN),
                          ("odd_asym", DNA), ("wide60", WIDE)):
        for rb in (1, 3, 256):
            for width in (1, 31, 1024, 16_000):
                cuts = sorted({rb, max(0, rb - 1)} | ({0} if rb == 3 else set()))
                for args in strip_case(name, letters, rb, width):
                    for m_true in cuts:
                        want = fill_cuda.strip_fill_block(*args, [m_true])
                        before = fill_cuda.strip_fill_block.launches
                        got = fill_cuda.strip_fill_block(
                            *strip_on_card(args), [m_true]
                        )
                        torch.cuda.synchronize()
                        if fill_cuda.strip_fill_block.launches != before + 1:
                            raise SystemExit("phase 1 failed: strip mode not "
                                             "launched")
                        err = max(abs_err(g, w) for g, w in zip(got, want))
                        strip_err = max(strip_err, err)
                        if err != 0:
                            raise SystemExit(
                                f"phase 1 failed: strip mode {name} RB={rb} "
                                f"W={args[1].shape[1] - 1} m_true={m_true}")
                log(f"phase 1: strip mode {name} RB={rb} W={width} (and the "
                    f"37-column strip at the matrix edge), m_true {cuts}: fin "
                    f"and every edge row max abs err 0")
    # At the pipeline's width: a 256-row block of a 50 000-column strip
    # whose col0 is the real right edge of the strip to its left.
    right_args = strip_case("dna", DNA, 256, 50_000)[1]
    for m_true in (255, 256):
        want = fill_cuda.strip_fill_block(*right_args, [m_true])
        got = fill_cuda.strip_fill_block(*strip_on_card(right_args), [m_true])
        torch.cuda.synchronize()
        err = max(abs_err(g, w) for g, w in zip(got, want))
        strip_err = max(strip_err, err)
        if err != 0:
            raise SystemExit(f"phase 1 failed: strip mode 256 x 50000 beside a "
                             f"neighbour, m_true={m_true}")
    log(f"phase 1: strip mode dna RB=256 W=50000 beside a 37-column neighbour "
        f"strip (its real right edge as col0), m_true [255, 256]: fin and every "
        f"edge row max abs err 0")

    # The wave kernel (TPU kernel #9) against its plain version (the wave
    # recurrence vectorised over rows, on the CPU): all four captured waves
    # at every row and the cost, tolerance 0, m + n <= 1 included, token
    # buffers padded past the true lengths on some shapes.  Schemes: the
    # JAX bench's wave arm (scoring 2 / -3 / -2, max score 2, gap open 4:
    # the default DNA scheme, also the (5, 4, 3) fuzz scheme of
    # tests/test_fill_pallas.py:469), its (1, 7, 1) and (9, 2, 6) schemes,
    # and odd_asym (dcost != icost).
    wave_schemes = {
        "bench = (5,4,3)": resolve_scheme(DNA, DNA),
        "(1,7,1)": resolve_scheme(DNA, DNA, mismatch_cost=1, gap_open_cost=7,
                                  gap_extension_cost=1),
        "(9,2,6)": resolve_scheme(DNA, DNA, mismatch_cost=9, gap_open_cost=2,
                                  gap_extension_cost=6),
        "odd_asym": schemes["odd_asym"](DNA, DNA),
    }
    wave_shapes = [  # (m, n), (padding of seq_1's and seq_2's buffers)
        ((0, 0), (0, 0)), ((0, 1), (2, 3)), ((1, 0), (0, 0)), ((1, 1), (3, 1)),
        ((2, 70), (5, 0)), ((70, 2), (0, 0)), ((1023, 1025), (0, 0)),
        ((1025, 1023), (0, 9)), ((4096, 4096), (0, 0)),
        ((12_345, 3000), (7, 7)), ((3000, 12_345), (0, 0)),
    ]
    # The tile edges of the kernel's plan: m, n = k H +- 1 and k 32 W +- 1.
    wave_plan = fill_wave.plan(4096, 4096)
    tile_h, tile_w = wave_plan.height, fill_wave.WARP * wave_plan.width
    wave_shapes += [
        ((tile_h - 1, tile_w + 1), (0, 0)), ((tile_h + 1, tile_w - 1), (2, 1)),
        ((2 * tile_h - 1, 2 * tile_w + 1), (0, 0)),
        ((2 * tile_h + 1, 3 * tile_w - 1), (0, 3)),
        ((3 * tile_h + 1, 2 * tile_w - 1), (1, 0)),
        ((5 * tile_h, 5 * tile_w), (0, 0)), ((3000, tile_w + 1), (0, 0)),
        ((tile_h - 1, 3000), (0, 0)),
    ]

    def wave_args(scheme, m, n, pad=(0, 0)):
        """Seeded tokens (CPU) and the scheme's uniform costs, as
        ``wave_frontiers`` takes them."""
        prm = fill_wave.uniform_scheme_params(scheme.costing.values,
                                              scheme.alphabet.gap_id)
        if prm is None:
            raise SystemExit("phase 1 failed: a wave scheme is not uniform")
        ta, tb = (
            torch.tensor([0, *scheme.alphabet.encode(random_seq(rng, DNA, k))],
                         dtype=torch.int32)
            for k in (m + pad[0], n + pad[1])
        )
        return (ta, tb, *prm, scheme.gap_open_cost, m, n)

    wave_err = 0
    for label, scheme in wave_schemes.items():
        for (m, n), pad in wave_shapes:
            args = wave_args(scheme, m, n, pad)
            on_card = (args[0].to(dev), args[1].to(dev), *args[2:])
            want = fill_wave.wave_frontiers(*args)
            want_cost = fill_wave.join_frontiers(want, args[6], m, n)
            before = fill_wave.wave_frontiers.launches
            got = fill_wave.wave_frontiers(*on_card)
            got_cost = fill_wave.wave_split_fill_cost(*on_card)
            torch.cuda.synchronize()
            if fill_wave.wave_frontiers.launches != before + 2:
                raise SystemExit("phase 1 failed: wave_split not launched")
            err = max(abs_err(got, want), abs_err(got_cost, want_cost))
            wave_err = max(wave_err, err)
            if err != 0:
                raise SystemExit(f"phase 1 failed: wave_split {label} {m} x {n}")
        log(f"phase 1: wave_split scheme {label} "
            f"{fill_wave.uniform_scheme_params(scheme.costing.values, scheme.alphabet.gap_id)}"
            f" go {scheme.gap_open_cost}, (m, n) {[s for s, _ in wave_shapes]}: "
            f"four captured waves at every row and the cost max abs err 0")

    # batch_final3_dual (TPU kernel #11's entry points) against its plain
    # version: two sets of B ragged pairs in one call, one gotoh_batch
    # launch a width class, across gotoh_batch's 1024-column cap (1025 and
    # 5000: one gotoh_fill final3 launch); short rows
    # (m_true 0..32) for many pairs, and rows near a 1024 bucket's top
    # (m_true 992..1024, the DNA chunk's widest buckets) for a few.
    dual_err = 0
    dual_cases = [(1, 0, 32), (33, 0, 32), (132, 0, 32), (5, 992, 1024)]
    for name, letters in (("dna", DNA), ("blosum62", PROTEIN),
                          ("wide60", WIDE)):
        for batch, lo, hi in dual_cases:
            for n_cols in (1, 64, fill_batch.MAX_COLUMNS, 1025, 5000):
                shapes = [(int(rng.integers(lo, hi + 1)),
                           int(rng.integers(0, n_cols + 1)))
                          for _ in range(2 * batch)]
                shapes[0] = (hi, n_cols)
                ta, tb, cost, gid, go, mt, nt = make_pairs(name, letters, shapes)
                args = (ta.reshape(2, batch, -1), tb.reshape(2, batch, -1), cost,
                        gid, go, np.reshape(mt, (2, batch)),
                        np.reshape(nt, (2, batch)))
                want = fill_batch.batch_final3_dual(*args)
                before = (fill_batch.batch_final3.launches
                          + fill_cuda.batch_moves.launches
                          + fill_tile.gotoh_tile.launches)
                got = fill_batch.batch_final3_dual(
                    args[0].to(dev), args[1].to(dev), cost.to(dev), *args[3:]
                )
                torch.cuda.synchronize()
                dual_design = 1 if n_cols > fill_batch.MAX_COLUMNS else len(
                    {fill_batch.width_class(n) for n in nt})
                if (fill_batch.batch_final3.launches
                        + fill_cuda.batch_moves.launches
                        + fill_tile.gotoh_tile.launches) != before + dual_design:
                    raise SystemExit("phase 1 failed: batch_final3_dual is not "
                                     "one launch a width class")
                err = abs_err(got, want)
                dual_err = max(dual_err, err)
                if err != 0:
                    raise SystemExit(f"phase 1 failed: batch_final3_dual {name} "
                                     f"B={batch} N={n_cols}")
        log(f"phase 1: batch_final3_dual {name}, 2 sets of (B, m_true) in "
            f"{[(b, f'{lo}..{hi}') for b, lo, hi in dual_cases]} x N in (1, 64, "
            f"1024, 1025, 5000): (2, B, 3) max abs err 0, one launch a width "
            f"class")

    # -- phase 2: the main path -----------------------------------------
    runs = [
        (dict(seq_1="ACGT", seq_2="AGT"), (0, 7)),
    ]
    for s1, s2, ma, mi, go, ge, score, cost in GOLDEN_E2E:
        runs.append((dict(seq_1=s1, seq_2=s2, match_score=ma,
                          mismatch_score=mi, gap_open_score=go,
                          gap_extension_score=ge), (score, cost)))
    s1 = random_seq(rng, DNA, 4096)
    runs.append((dict(seq_1=s1, seq_2=mutate(rng, s1, DNA)), None))
    s1 = random_seq(rng, DNA, 8000)
    runs.append((dict(seq_1=s1, seq_2=mutate(rng, s1, DNA)), None))
    s1 = random_seq(rng, PROTEIN, 1500)
    runs.append((dict(seq_1=s1, seq_2=mutate(rng, s1, PROTEIN),
                      scoring_mat_name="BLOSUM62"), None))

    want = [find_global_alignment(**kw, device="cpu") for kw, _ in runs]
    torch.cuda.synchronize()
    reset_counts()
    got = [find_global_alignment(**kw, device="cuda") for kw, _ in runs]
    counts = read_counts()
    add_main(counts)
    for (kw, golden), r, w in zip(runs, got, want):
        m, n = len(kw["seq_1"]), len(kw["seq_2"])
        if r != w or str(r) != str(w):
            raise SystemExit(f"phase 2 failed: cuda != cpu for {m} x {n}")
        if golden is not None and (r.score, r.cost) != golden:
            raise SystemExit(f"phase 2 failed: golden {golden} got "
                             f"{(r.score, r.cost)}")
        log(f"phase 2: {m} x {n}: score {r.score} cost {r.cost} "
            f"(= device='cpu')")
    single_design = design(
        *[(1, len(kw["seq_1"]), len(kw["seq_2"]), True, "batch_moves")
          for kw, _ in runs], walk_block=len(runs))
    if counts != single_design:
        raise SystemExit(f"phase 2 failed: launches {counts} for "
                         f"{len(runs)} align calls, design {single_design}")
    log(f"phase 2: launches on the full-matrix path (a fill and a walk a "
        f"pair; the fill on gotoh_tile where fill_tile.route sends it): "
        f"{counts}")

    # The card's walk on the main path against an independent oracle: the
    # host walk (ops/traceback.traceback_moves) over the same codes, fetched
    # whole, for the 8000^2 DNA and the 1500^2 BLOSUM62 pair.
    for (kw, _), r in zip(runs, got):
        if len(kw["seq_1"]) not in (8000, 1500):
            continue
        aligner = GotohAligner(validate_and_transform_args(**kw).scheme,
                               device="cuda")
        f3, mv = aligner._batch_fill(kw["seq_1"], kw["seq_2"], want_moves=True)
        want_tb = traceback_moves(mv[0].cpu().numpy(), kw["seq_1"],
                                  kw["seq_2"], f3[0].cpu().numpy())
        if (r.seq_1_aligned, r.middle_part, r.seq_2_aligned, r.cost) != tuple(
                want_tb):
            raise SystemExit(f"phase 2 failed: the card's walk != "
                             f"traceback_moves at {len(kw['seq_1'])}")
        with gotoh_fill_only(fill_tile):  # the route before gotoh_tile
            old_route = find_global_alignment(**kw, device="cuda")
        if old_route != r or str(old_route) != str(r):
            raise SystemExit(f"phase 2 failed: the gotoh_tile route != the "
                             f"gotoh_fill route at {len(kw['seq_1'])}")
        log(f"phase 2: {len(kw['seq_1'])} x {len(kw['seq_2'])}"
            f"{' ' + kw['scoring_mat_name'] if 'scoring_mat_name' in kw else ''}"
            f": align (walked on the card) = traceback_moves over the fetched "
            f"codes (strings and cost) = the same align on gotoh_fill")

    # A custom matrix over non-ASCII letters: single pairs and align_pairs
    # in both modes on the card = device="cpu", strings and reports (the
    # port renders any letter; ROADMAP C5 is the JAX native layer's fault).
    # The matrix is phase 1's (uni_letters, uni_mtx).
    uni_pairs = [(random_seq(rng, uni_letters, m), random_seq(rng, uni_letters, n))
                 for m, n in ((300, 280), (1, 9), (700, 650), (64, 1), (90, 95))]
    with tempfile.TemporaryDirectory() as tmp:
        mtx = Path(tmp) / "unicode.mtx"
        mtx.write_text(uni_mtx, encoding="utf-8")
        uni_want = [find_global_alignment(seq_1=a, seq_2=b, scoring_mat_path=mtx,
                                      device="cpu") for a, b in uni_pairs]
        torch.cuda.synchronize()
        reset_counts()
        uni_got = [find_global_alignment(seq_1=a, seq_2=b, scoring_mat_path=mtx,
                                     device="cuda") for a, b in uni_pairs]
        uni_counts = read_counts()
        add_main(uni_counts)
        if uni_got != uni_want or [str(r) for r in uni_got] != [
            str(r) for r in uni_want
        ] or (
            uni_counts != design(*[(1, len(a), len(b), True, "batch_moves")
                                   for a, b in uni_pairs],
                                 walk_block=len(uni_pairs))
        ):
            raise SystemExit(f"phase 2 failed: non-ASCII single pairs, "
                             f"launches {uni_counts}")
        for with_tb in (False, True):
            want_b = align_pairs(uni_pairs, scoring_mat_path=mtx,
                                 with_traceback=with_tb, device="cpu")
            reset_counts()
            got_b = align_pairs(uni_pairs, scoring_mat_path=mtx,
                                with_traceback=with_tb)
            add_main(read_counts())
            if [(r.cost, r.score, r.seq_1_aligned, r.seq_2_aligned)
                    for r in got_b] != [(r.cost, r.score, r.seq_1_aligned,
                                         r.seq_2_aligned) for r in want_b]:
                raise SystemExit(f"phase 2 failed: non-ASCII align_pairs "
                                 f"traceback={with_tb}")
    log(f"phase 2: a non-ASCII custom matrix ({uni_letters}): "
        f"{len(uni_pairs)} single pairs (strings, cost, score, report) and "
        f"align_pairs both modes on the card = device='cpu'; e.g. "
        f"{uni_got[1].seq_1_aligned} / {uni_got[1].seq_2_aligned}")

    # Past the moves budget: the blocked route, held against the
    # full-matrix route (the same call with the budget raised).
    def full_matrix_route(**kw):
        real = api.GotohAligner
        api.GotohAligner = functools.partial(real, moves_budget_bytes=1 << 40)
        try:
            return find_global_alignment(**kw, device="cuda")
        finally:
            api.GotohAligner = real

    long_runs, long_results = [], []
    for size, letters, kw in ((10_000, DNA, {}), (20_000, DNA, {}),
                              (9_000, PROTEIN,
                               dict(scoring_mat_name="BLOSUM62"))):
        s1 = random_seq(rng, letters, size)
        long_runs.append(dict(seq_1=s1, seq_2=mutate(rng, s1, letters), **kw))
    for kw in long_runs:
        m, n = len(kw["seq_1"]), len(kw["seq_2"])
        nblocks = len(linear_tb.block_bounds(
            m, n, block_moves_bytes=DEFAULT_MOVES_BUDGET_BYTES
        )) - 1
        torch.cuda.synchronize()
        reset_counts()
        r = find_global_alignment(**kw, device="cuda")
        counts = read_counts()
        add_main(counts)
        long_results.append(r)
        # the checkpoint pass: one gotoh_tile launch; a replay fill a block
        blocked_design = design(*blocked_fills(m, n), gotoh_tile=1,
                                walk_block=nblocks)
        w = full_matrix_route(**kw)
        if r != w or str(r) != str(w):
            raise SystemExit(f"phase 2 failed: blocked != full matrix for "
                             f"{m} x {n}")
        if counts != blocked_design:
            raise SystemExit(f"phase 2 failed: {m} x {n} launches {counts}, "
                             f"design {blocked_design}")
        log(f"phase 2: blocked {m} x {n} ({nblocks} blocks): score {r.score} "
            f"cost {r.cost} (= full-matrix route, report bytes equal); "
            f"launches {counts}")

    # A small pair forced into >= 4 blocks, against the CPU engine.
    s1 = random_seq(rng, DNA, 3000)
    forced = dict(seq_1=s1, seq_2=mutate(rng, s1, DNA)[:2500])
    scheme = resolve_scheme(forced["seq_1"], forced["seq_2"])
    budget = 2_000_000
    nblocks = len(linear_tb.block_bounds(
        len(forced["seq_1"]), len(forced["seq_2"]), block_moves_bytes=budget
    )) - 1
    want_forced = find_global_alignment(**forced, device="cpu")
    torch.cuda.synchronize()
    reset_counts()
    r = GotohAligner(scheme, moves_budget_bytes=budget, device="cuda").align(
        forced["seq_1"], forced["seq_2"]
    )
    counts = read_counts()
    add_main(counts)
    if nblocks < 4 or counts != design(*blocked_fills(3000, 2500, budget),
                                       gotoh_tile=1, walk_block=nblocks):
        raise SystemExit(f"phase 2 failed: forced blocks {nblocks}, "
                         f"launches {counts}")
    if (r.seq_1_aligned, r.middle_part, r.seq_2_aligned, r.cost, r.score) != (
        want_forced.seq_1_aligned, want_forced.middle_part,
        want_forced.seq_2_aligned, want_forced.cost, want_forced.score,
    ):
        raise SystemExit("phase 2 failed: forced blocks != device='cpu'")
    log(f"phase 2: 3000 x 2500 in {nblocks} blocks: cost {r.cost} "
        f"(= device='cpu'); launches {counts}")

    # cost(): the split, one launch, on every pair above.
    cost_runs = (
        [(kw, w) for (kw, _), w in zip(runs, want)]
        + list(zip(long_runs, long_results))
        + [(forced, want_forced)]
    )
    for kw, r in cost_runs:
        s1, s2 = kw["seq_1"], kw["seq_2"]
        aligner = GotohAligner(
            validate_and_transform_args(**kw).scheme, device="cuda"
        )
        torch.cuda.synchronize()
        reset_counts()
        c = aligner.cost(s1, s2)
        counts = read_counts()
        add_main(counts)
        split = len(s1) >= SPLIT_MIN_ROWS
        cost_design = design(
            (2, len(s1) - len(s1) // 2, len(s2), False, "batch_last_rows")
            if split else (1, len(s1), len(s2), False, "batch_moves"))
        direct, _ = aligner._batch_fill(s1, s2, want_moves=False)
        if counts != cost_design or c != int(direct.min()) or c != r.cost:
            raise SystemExit(f"phase 2 failed: cost {c} direct "
                             f"{int(direct.min())} align {r.cost} launches "
                             f"{counts} for {len(s1)} x {len(s2)}")
    log(f"phase 2: cost on {len(cost_runs)} pairs (the split from "
        f"{SPLIT_MIN_ROWS} rows) = direct fill = alignment cost; one launch "
        "each")

    # Batch serving: align_pairs on the runner's default chunk (1024 pairs,
    # lengths 819-1024, ~7 x 7 buckets at quantum 32), DNA and BLOSUM62,
    # cost-only and traceback, against the single-pair path on the card.
    def fields(r):
        return (r.cost, r.score, r.seq_1_aligned, r.middle_part,
                r.seq_2_aligned)

    def bucket_counts(pairs, budget=None):
        """Launch plan of align_pairs: bucket sizes, split by the budget."""
        keys = {}
        for a, b in pairs:
            key = (bucket_length(len(a)), bucket_length(len(b)))
            keys[key] = keys.get(key, 0) + 1
        if budget is None:
            return len(keys), len(keys)
        subs = sum(-(-k // (budget // fill_cuda.ragged_bytes(mm, nn)))
                   for (mm, nn), k in keys.items())
        return len(keys), subs

    def segments_of(pairs, budget, capacity):
        """align_pairs' traceback segments, by its rule: buckets in order
        of first appearance, each one's pairs in input order, a segment
        closed where its codes (fill_cuda.ragged_bytes a pair) would pass
        ``capacity`` (the segment capacity); a bucket whose padded pair
        passes ``budget`` (the moves budget) goes blocked and joins none.
        The (m, n) of each segment's pairs."""
        size = fill_cuda.ragged_bytes
        keys = {}
        for a, b in pairs:
            keys.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                            []).append((len(a), len(b)))
        segs, used = [[]], 0
        for (mm, nn), shapes in keys.items():
            if size(mm, nn) > budget:
                continue
            for m, n in shapes:
                if used + size(m, n) > capacity:
                    segs.append([])
                    used = 0
                segs[-1].append((m, n))
                used += size(m, n)
        return [seg for seg in segs if seg]

    # The card's moves budget (blocked) and segment capacity (segments).
    here = torch.device("cuda", torch.cuda.current_device())
    tb_bounds = (batch_mod._moves_budget(here), batch_mod._segment_budget(here))

    def traceback_launches(pairs, alphabet, budget, capacity):
        """(gotoh_batch_moves launches, gotoh_fill ragged launches, ragged
        walks) of a traceback align_pairs call: a launch a width class and
        a launch a launch class of each segment (fill_cuda.ragged_routes),
        a walk a segment."""
        segs = segments_of(pairs, budget, capacity)
        routes = [fill_cuda.ragged_routes(*zip(*seg), alphabet, sms)
                  for seg in segs]
        return (sum(len(w) for w, _ in routes), sum(len(c) for _, c in routes),
                len(segs))

    def mesh_fills(pairs, budget):
        """The moves fills of align_pairs(mesh=world of one, traceback): a
        bucket sub-batch each, under the budget, as (B, its longest m and
        n, codes, wrapper)."""
        keys = {}
        for a, b in pairs:
            keys.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                            []).append((len(a), len(b)))
        out = []
        for (mm, nn), shapes in keys.items():
            per = budget // fill_cuda.ragged_bytes(mm, nn)
            for lo in range(0, len(shapes), per):
                group = shapes[lo : lo + per]
                out.append((len(group), max(m for m, _ in group),
                            max(n for _, n in group), True, "batch_moves"))
        return out

    # An unsharded call's letters: one upload, one tokenize launch, one
    # fetch (and one render launch a traceback segment).
    packed_design = dict(letters_upload=1, tokenize_ragged=1, fetch=1)

    def cost_launches(pairs):
        """gotoh_batch launches of a cost-only align_pairs call: one per
        width class of the pairs (every bucket within the cap)."""
        if any(bucket_length(len(b)) > fill_batch.MAX_COLUMNS for _, b in pairs):
            raise SystemExit("phase 2 failed: a chunk bucket past the cap")
        return len({fill_batch.width_class(len(b)) for _, b in pairs})

    chunks = {"dna": (serving_chunk(rng, DNA, 1024, 819, 1024), {}),
              "blosum62": (serving_chunk(rng, PROTEIN, 1024, 819, 1024),
                           dict(scoring_mat_name="BLOSUM62"))}
    chunk_results = {}  # (chunk, traceback) -> align_pairs' results
    for name, (pairs, kw) in chunks.items():
        scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
        aligner = GotohAligner(scheme, device="cuda")
        nbuckets = bucket_counts(pairs)[0]
        nwarp, nfills, nwalks = traceback_launches(
            pairs, len(scheme.costing.values), *tb_bounds)
        if (nfills, nwalks) != (0, 1) or nwarp != len(
                {fill_batch.width_class(len(b)) for _, b in pairs}):
            raise SystemExit(f"phase 2 failed: the {name} chunk is "
                             f"{nwalks} segments, {nwarp} width classes and "
                             f"{nfills} gotoh_fill launch classes")
        for with_tb in (False, True):
            torch.cuda.synchronize()
            reset_counts()
            got = align_pairs(pairs, scheme=scheme, with_traceback=with_tb)
            counts = read_counts()
            add_main(counts)
            chunk_results[name, with_tb] = (got, counts)
            chunk_design = (  # cost-only: one gotoh_batch launch a width class
                launches(batch_moves_warp=nwarp, walk_ragged=nwalks,
                         render_ragged=nwalks, **packed_design)
                if with_tb else launches(batch_final3=cost_launches(pairs),
                                         **packed_design)
            )
            if counts != chunk_design:
                raise SystemExit(f"phase 2 failed: align_pairs {name} "
                                 f"traceback={with_tb} launches {counts}, "
                                 f"design {chunk_design}")
            for (s1, s2), r in zip(pairs, got):
                if with_tb:
                    w = aligner.align(s1, s2)
                    want = (w.cost, w.score, w.seq_1_aligned, w.middle_part,
                            w.seq_2_aligned)
                else:
                    c = aligner.cost(s1, s2)
                    want = (c, final_cost_to_score(
                        cost=c, m=len(s1), n=len(s2),
                        max_score=scheme.max_score,
                    ), None, None, None)
                if fields(r) != want:
                    raise SystemExit(f"phase 2 failed: align_pairs {name} "
                                     f"traceback={with_tb} != single pair "
                                     f"{len(s1)} x {len(s2)}")
            subset = pairs[:32]
            cpu = align_pairs(subset, scheme=scheme, with_traceback=with_tb,
                              device="cpu")
            if [fields(r) for r in cpu] != [fields(r) for r in got[:32]]:
                raise SystemExit(f"phase 2 failed: align_pairs {name} "
                                 f"traceback={with_tb} != device='cpu'")
            log(f"phase 2: align_pairs {name} 1024 pairs ({nbuckets} buckets), "
                f"traceback={with_tb}: = single-pair path on the card, first "
                f"32 = device='cpu'; launches {counts} (cost-only: one "
                f"gotoh_batch launch a width class; traceback: one "
                f"gotoh_batch_moves launch a width class, no gotoh_fill "
                f"launch, and one ragged walk and one render a segment; "
                f"one letters upload, one tokenize, one fetch a call; a "
                f"launch a bucket made {nbuckets})")

    # A lowered moves budget and segment capacity: the 300-nt pairs split
    # into three or more segments and the 1200 x 1100 pair goes blocked;
    # equal to the default bounds' result and to the CPU.
    mixed = serving_chunk(rng, DNA, 12, 290, 300)
    s1 = random_seq(rng, DNA, 1200)
    mixed.insert(5, (s1, mutate(rng, s1, DNA)[:1100]))
    want = align_pairs(mixed)
    real_budget = batch_mod.DEVICE_WALK_MOVES_BUDGET
    real_capacity = batch_mod._segment_budget
    batch_mod.DEVICE_WALK_MOVES_BUDGET = budget = 400_000
    batch_mod._segment_budget = lambda device: budget
    try:
        torch.cuda.synchronize()
        reset_counts()
        got = align_pairs(mixed)
        counts = read_counts()
    finally:
        batch_mod.DEVICE_WALK_MOVES_BUDGET = real_budget
        batch_mod._segment_budget = real_capacity
    add_main(counts)
    nwarp, nfills, nsegs = traceback_launches(mixed, 5, budget, budget)
    mixed_design = design(  # the blocked pair: its checkpoint pass and replay
        *blocked_fills(1200, 1100), batch_moves_warp=nwarp,
        batch_moves_ragged=nfills, walk_ragged=nsegs, gotoh_tile=1,
        walk_block=1, render_ragged=nsegs, **packed_design)
    cpu = align_pairs(mixed, device="cpu")
    if [fields(r) for r in got] != [fields(r) for r in want] or [
        fields(r) for r in cpu
    ] != [fields(r) for r in want] or counts != mixed_design or nsegs < 3:
        raise SystemExit(f"phase 2 failed: budget {budget}: launches {counts}, "
                         f"design {mixed_design}")
    log(f"phase 2: align_pairs under a {budget}-byte budget: {nsegs} "
        f"segments + one blocked 1200 x 1100 pair = default budget = "
        f"device='cpu'; launches {counts}")

    # Both routes in one traceback call: pairs of 290-1000 columns on
    # gotoh_batch_moves, pairs of 1100-2300 on gotoh_fill's ragged mode,
    # one buffer and one walk; = the single-pair path and device="cpu".
    wide_call = serving_chunk(rng, DNA, 12, 290, 1000)
    for k, size in ((2, 1100), (7, 2300), (9, 1500)):
        s1 = random_seq(rng, DNA, size)
        wide_call.insert(k, (s1, mutate(rng, s1, DNA)))
    torch.cuda.synchronize()
    reset_counts()
    got = align_pairs(wide_call)
    counts = read_counts()
    add_main(counts)
    nwarp, nfills, nsegs = traceback_launches(wide_call, 5, *tb_bounds)
    wide_design = launches(batch_moves_warp=nwarp, batch_moves_ragged=nfills,
                           walk_ragged=nsegs, render_ragged=nsegs,
                           **packed_design)
    aligner = GotohAligner(resolve_scheme(DNA, DNA), device="cuda")
    single = [fields(aligner.align(a, b)) for a, b in wide_call]
    cpu = align_pairs(wide_call, device="cpu")
    if [fields(r) for r in got] != single or [fields(r) for r in cpu] != single or (
            counts != wide_design) or not (nwarp and nfills):
        raise SystemExit(f"phase 2 failed: align_pairs across the 1024-column "
                         f"cap: launches {counts}, design {wide_design}")
    log(f"phase 2: align_pairs over {len(wide_call)} pairs of 290-2300 "
        f"columns (both routes): = single-pair path = device='cpu'; launches "
        f"{counts} ({nwarp} gotoh_batch_moves, {nfills} gotoh_fill ragged, "
        f"{nsegs} walk)")

    # The wide route in a cost-only call: a BLOSUM62 call of the protein
    # mix's lengths (log-normal, median 300, sigma 0.6, 30-4000), its pairs
    # past 1024 columns all in one gotoh_tile launch (fill_tile.route_buckets)
    # and no gotoh_fill launch; = the single-pair path's cost = device="cpu".
    lengths = np.clip(np.round(300 * np.exp(0.6 * rng.standard_normal(256))),
                      30, 4000).astype(int).tolist()
    tail_call = []
    for size in lengths + [1100, 2600, 3900]:
        s1 = random_seq(rng, PROTEIN, size)
        tail_call.append((s1, mutate(rng, s1, PROTEIN)))
    blosum = resolve_scheme(PROTEIN, PROTEIN, scoring_mat_name="BLOSUM62")
    tail_buckets = collections.defaultdict(lambda: ([], []))
    for a, b in tail_call:
        key = (bucket_length(len(a)), bucket_length(len(b)))
        tail_buckets[key][0].append(len(a))
        tail_buckets[key][1].append(len(b))
    tail = [v for (_, nb), v in tail_buckets.items() if nb > fill_batch.MAX_COLUMNS]
    if fill_tile.route_buckets(tail, sms) != list(range(len(tail))):
        raise SystemExit("phase 2 failed: the wide route refuses the protein tail")
    torch.cuda.synchronize()
    reset_counts()
    got = align_pairs(tail_call, scheme=blosum, with_traceback=False)
    counts = read_counts()
    add_main(counts)
    narrow = [(a, b) for a, b in tail_call
              if bucket_length(len(b)) <= fill_batch.MAX_COLUMNS]
    tail_design = launches(batch_final3=cost_launches(narrow), gotoh_tile=1,
                           wide_launches=1,
                           wide_pairs=sum(len(m) for m, _ in tail),
                           **packed_design)
    blosum_aligner = GotohAligner(blosum, device="cuda")
    single = [blosum_aligner.cost(a, b) for a, b in tail_call]
    cpu = align_pairs(tail_call, scheme=blosum, with_traceback=False,
                      device="cpu")
    if [r.cost for r in got] != single or got != cpu or counts != tail_design:
        raise SystemExit(f"phase 2 failed: the wide route: launches {counts}, "
                         f"design {tail_design}")
    log(f"phase 2: align_pairs cost-only over {len(tail_call)} protein pairs, "
        f"{len(tail)} buckets past 1024 columns ({counts['wide_pairs']} pairs) "
        f"in one gotoh_tile launch: = cost() = device='cpu'; launches {counts}")

    # flush=False: nothing fetched until resolve(), which equals flush=True.
    dna_pairs = chunks["dna"][0]
    want = align_pairs(dna_pairs)
    torch.cuda.synchronize()
    reset_counts()
    pending = align_pairs(dna_pairs, flush=False)
    counts = read_counts()
    got = pending.resolve()
    add_main(counts)
    if [fields(r) for r in got] != [fields(r) for r in want]:
        raise SystemExit("phase 2 failed: flush=False then resolve() != flush")
    if (counts["fetch"], counts["render_ragged"], counts["tokenize_ragged"],
            counts["letters_upload"]) != (0, 1, 1, 1):
        raise SystemExit(f"phase 2 failed: flush=False fetched or did not "
                         f"queue its render: {counts}")
    log(f"phase 2: align_pairs(flush=False).resolve() = flush=True on the DNA "
        f"chunk; launches {counts}")

    # -- phase 2, a call's letters: tokenize_ragged and render_ragged -----
    # Each kernel against its plain version (ops/packed.py, run on the card
    # on the same tensors), tolerance 0, at the main path's shapes: both
    # 1024-pair chunks packed as align_pairs packs them, each chunk's
    # traceback segment rendered from the tapes of its own fill and walk; a
    # 1024-pair chunk under the non-ASCII matrix (code points); and an arena
    # and a lines buffer whose rows lie past byte 2^31 (ROADMAP C1).  The
    # rendered lines of both ASCII chunks also = the numpy route's strings
    # (the tapes fetched, reversed behind their left moves,
    # linear_tb.render_many).
    def pack_of(pairs, scheme):
        """align_pairs' pack of ``pairs`` on the card, uploaded and
        tokenized: (the packed call, the pairs in pack order)."""
        keys = {}
        for k, (a, b) in enumerate(pairs):
            keys.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                            []).append(k)
        spec = [([pairs[i][0] for i in idx], [pairs[i][1] for i in idx], mm, nn)
                for (mm, nn), idx in keys.items()]
        call = packed.pack_call(scheme.alphabet, spec, with_render=True,
                                pin=True)
        call.upload(dev)
        call.tokenize()
        return call, [pairs[i] for idx in keys.values() for i in idx]

    def walked(call, order, scheme):
        """The chunk's one traceback segment on the card: (ops, count,
        j_exit) of its ragged fill and walk over the arena's buckets."""
        cost = torch.from_numpy(np.ascontiguousarray(
            scheme.costing.values, dtype=np.int32)).to(dev)
        tas, tbs, mts, nts, row = [], [], [], [], 0
        for k, (_, _, nb, _, _) in enumerate(call.slots):
            ta, tb = call.bucket(k)
            tas.append(ta)
            tbs.append(tb)
            mts.append([len(a) for a, _ in order[row : row + nb]])
            nts.append([len(b) for _, b in order[row : row + nb]])
            row += nb
        filled = fill_cuda.batch_moves_ragged(
            tas, tbs, cost, scheme.alphabet.gap_id, scheme.gap_open_cost,
            mts, nts)
        return linear_tb.walk_ragged(filled)

    def token_check(call, shift=0):
        """max |tokenize_ragged - tokenize_plain| over the arena, the rows
        placed ``shift`` tokens further into an arena of their own."""
        want = packed.tokenize_plain(call.letters, call.table, call.token_desc,
                                     torch.zeros_like(call.arena))
        desc = call.token_desc.clone()
        desc[:, 2] += shift
        arena = torch.zeros(shift + call.arena_size, dtype=torch.int32,
                            device=dev)
        packed.tokenize_ragged(call.letters, call.table, desc, arena)
        torch.cuda.synchronize()
        return int((arena[shift:].long() - want.long()).abs().max())

    def render_check(call, walk, base=0):
        """max |render_ragged - render_plain| over the lines and ends, the
        lines written from ``base`` into a buffer of their own."""
        ops, count, j_exit = walk
        lens = count.long() + j_exit.long()
        total = int(lens.sum())
        want = torch.zeros_like(call.lines())
        packed.render_plain(ops, count, j_exit, torch.cumsum(lens, 0) - lens,
                            call.letters, call.render_desc, want)
        got = torch.zeros((3, base + call.line_cap), dtype=want.dtype,
                          device=dev)
        ends = packed.render_ragged(
            ops, count, j_exit, call.letters, call.render_desc, got,
            torch.tensor([base], dtype=torch.int64, device=dev))
        torch.cuda.synchronize()
        err = int((got[:, base : base + total].long()
                   - want[:, :total].long()).abs().max())
        return max(err, int((ends - base - torch.cumsum(lens, 0)).abs().max()))

    def numpy_strings(walk, order):
        """The numpy route's lines: the tapes fetched, each reversed behind
        its row-0 left moves, linear_tb.render_many."""
        tapes, counts, j_exits = (x.cpu().numpy() for x in walk)
        fwd = [np.concatenate((np.full(j_exits[k], linear_tb.OP_LEFT, np.uint8),
                               tapes[k, : counts[k]][::-1]))
               for k in range(len(order))]
        return linear_tb.render_many(fwd, [a for a, _ in order],
                                     [b for _, b in order])

    packed_rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        mtx = Path(tmp) / "unicode.mtx"
        mtx.write_text(uni_mtx, encoding="utf-8")
        letter_sets = {
            "dna": chunks["dna"],
            "blosum62": chunks["blosum62"],
            "non-ASCII": (serving_chunk(rng, uni_letters, 1024, 819, 1024),
                          dict(scoring_mat_path=mtx)),
        }
        for name, (pairs, kw) in letter_sets.items():
            scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
            call, order = pack_of(pairs, scheme)
            tok_err = token_check(call)
            walk = walked(call, order, scheme)
            ren_err = render_check(call, walk)
            lines = call.lines()
            ends = packed.render_ragged(*walk, call.letters, call.render_desc,
                                        lines)
            host_lines, host_ends = batch_mod._to_host([lines, ends])
            strings = packed.decode_lines(host_lines, host_ends, call.wide)
            same = strings == numpy_strings(walk, order)
            packed_rec[name] = dict(
                call=call, walk=walk, order=order, scheme=scheme,
                tokenize_err=tok_err, render_err=ren_err, wide=call.wide,
            )
            log(f"phase 2: tokenize_ragged / render_ragged on the {name} "
                f"chunk ({len(pairs)} pairs, {len(call.slots)} buckets, "
                f"{'code points' if call.wide else 'bytes'}): max abs err "
                f"against the plain versions {tok_err} / {ren_err}; lines = "
                f"the numpy route's: {same}")
            if tok_err or ren_err or not same:
                raise SystemExit(f"phase 2 failed: tokenize_ragged / "
                                 f"render_ragged on the {name} chunk")
        # Past byte 2^31: the DNA chunk's rows 2^29 + 64 tokens into an
        # arena (2.2 GB), its lines from 2^30 + 4096 letters on in a lines
        # buffer of 3 rows (line 1 from byte 2^31 + 8192 on, 3.2 GB).
        rec = packed_rec["dna"]
        far_tok = token_check(rec["call"], shift=(1 << 29) + 64)
        far_ren = render_check(rec["call"], rec["walk"], base=(1 << 30) + 4096)
        log(f"phase 2: tokenize_ragged with its rows past byte 2^31 of a "
            f"{4 * ((1 << 29) + 64 + rec['call'].arena_size) / 1e9:.2f} GB "
            f"arena, render_ragged with its lines past byte 2^31 of a "
            f"{3 * ((1 << 30) + 4096 + rec['call'].line_cap) / 1e9:.2f} GB "
            f"buffer: max abs err {far_tok} / {far_ren}")
        if far_tok or far_ren:
            raise SystemExit("phase 2 failed: tokenize / render past byte 2^31")
        torch.cuda.empty_cache()
    packed_err = max(max(r["tokenize_err"], r["render_err"])
                     for r in packed_rec.values())

    # The batch CLI on the card and on the CPU: the same results TSV, byte
    # for byte, and the same manifest fingerprint.
    cli_pairs = serving_chunk(rng, DNA, 512, 50, 300)
    with tempfile.TemporaryDirectory() as tmp:
        tsv = Path(tmp) / "pairs.tsv"
        tsv.write_text("".join(f"{a}\t{b}\n" for a, b in cli_pairs))
        outs = {}
        for device in ("cuda", "cpu"):
            out = Path(tmp) / f"out_{device}.tsv"
            proc = subprocess.run(
                [sys.executable, "-m", "globalign_tpu_torch.batch_cli",
                 "--pairs_tsv", str(tsv), "-o", str(out), "--with_traceback",
                 "--cigar", "--device", device],
                cwd=REPO, capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                raise SystemExit(f"phase 2 failed: batch_cli --device {device}"
                                 f": {proc.stderr[-2000:]}")
            manifest = out.with_name(out.name + ".manifest.jsonl")
            prints = {json.loads(line)["fingerprint"]
                      for line in manifest.read_text().splitlines()}
            outs[device] = (out.read_bytes(), prints)
            log(f"phase 2: batch_cli --device {device}: "
                f"{proc.stderr.strip().splitlines()[-1]}")
    if outs["cuda"] != outs["cpu"] or len(outs["cuda"][0].splitlines()) != 512:
        raise SystemExit("phase 2 failed: batch_cli TSVs or fingerprints differ")
    log(f"phase 2: batch_cli --with_traceback --cigar over 512 pairs of "
        f"50-300 nt: results TSVs byte-identical ({len(outs['cuda'][0])} "
        f"bytes), manifest fingerprints {sorted(outs['cuda'][1])} on both")

    # -- phase 2, the parallel layer --------------------------------------
    # A world of one on NCCL (the production mesh on one H100): align_pairs
    # over the mesh on both chunks, both modes, equal to the unsharded
    # call, with a launch a bucket (the mesh path shards each bucket): a
    # gotoh_batch launch cost-only, a gotoh_fill moves launch and a
    # walk_block launch with traceback; sharded_pair_cost on a 50 000 x 50 000
    # DNA pair, one strip-mode launch a block, equal to cost() (the split).
    from globalign_tpu_torch.parallel import make_pair_mesh, multihost, seqpar

    multihost.initialize(num_processes=1)
    world1 = make_pair_mesh()
    if world1.backend != "nccl":
        raise SystemExit(f"phase 2 failed: world of one on {world1.backend}")
    for name, (pairs, kw) in chunks.items():
        scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
        for with_tb in (False, True):
            want, _ = chunk_results[name, with_tb]
            nbuckets, nsubs = bucket_counts(
                pairs, batch_mod.DEVICE_WALK_MOVES_BUDGET)
            want_counts = (  # the mesh path keeps a launch a bucket shard
                design(*mesh_fills(pairs, batch_mod.DEVICE_WALK_MOVES_BUDGET),
                       walk_block=nsubs, fetch=1) if with_tb
                else launches(batch_final3=nbuckets, fetch=1))
            torch.cuda.synchronize()
            reset_counts()
            got = align_pairs(pairs, scheme=scheme, with_traceback=with_tb,
                              mesh=world1)
            counts = read_counts()
            add_main(counts)
            if [fields(r) for r in got] != [fields(r) for r in want] or (
                counts != want_counts
            ):
                raise SystemExit(f"phase 2 failed: align_pairs(mesh=world of "
                                 f"one) {name} traceback={with_tb}: launches "
                                 f"{counts}, unsharded {want_counts}")
            log(f"phase 2: align_pairs(mesh=NCCL world of one) {name} "
                f"traceback={with_tb}: = unsharded, pair by pair; launches "
                f"{counts}")

    def pair_of(letters, size):
        s1 = random_seq(rng, letters, size)
        return s1, mutate(rng, s1, letters)

    big_pair = pair_of(DNA, 50_000)
    blosum_pair = pair_of(PROTEIN, 20_000)
    world1_cost = {}
    for label, (s1, s2), kw in (("50000^2 DNA", big_pair, {}),
                                ("20000^2 BLOSUM62", blosum_pair,
                                 dict(scoring_mat_name="BLOSUM62"))):
        aligner = GotohAligner(resolve_scheme(s1, s2, **kw), device="cuda")
        enc = (aligner._encode(s1), aligner._encode(s2), aligner.cost_mat,
               aligner.gap_id, aligner.gap_open)
        torch.cuda.synchronize()
        reset_counts()
        final3 = seqpar.sharded_pair_cost(world1, *enc)
        counts = read_counts()
        add_main(counts)
        nblocks = -(-len(s1) // seqpar.DEFAULT_BLOCK_ROWS)
        split_cost = aligner.cost(s1, s2)
        if int(final3.min()) != split_cost or counts != launches(
            strip_fill_block=nblocks
        ):
            raise SystemExit(f"phase 2 failed: sharded_pair_cost {label}: "
                             f"{final3.tolist()} against cost() {split_cost}, "
                             f"launches {counts}")
        world1_cost[label] = (final3.tolist(), aligner, enc)
        log(f"phase 2: sharded_pair_cost(NCCL world of one) {label}: lanes "
            f"{final3.tolist()}, cost {split_cost} = cost() (the split); "
            f"launches {counts}")

    # Four gloo ranks sharing the card (spawned; exchanges staged through
    # pinned host memory): the same pairs, the 20 000^2 blocked alignment
    # and the DNA chunk, every rank equal to the world of one / unsharded,
    # one strip-mode launch per block of each rank's pipeline.
    blocked_kw = long_runs[1]
    if len(blocked_kw["seq_1"]) != 20_000 or blocked_kw.get("scoring_mat_name"):
        raise SystemExit("phase 2 failed: the 20 000^2 DNA run moved")
    blocked_want = long_results[1]
    dna_chunk = chunks["dna"][0]
    dna_seqs = ["".join(s) for s in zip(*dna_chunk)]

    def job(pair, kw):
        return dict(pair=pair, scheme_seqs=list(pair), scheme_kw=kw)

    gloo_jobs = [
        ("cost", job(big_pair, {})),
        ("cost", job(blosum_pair, dict(scoring_mat_name="BLOSUM62"))),
        ("blocked", job((blocked_kw["seq_1"], blocked_kw["seq_2"]), {})),
        ("pairs", dict(pairs=dna_chunk, traceback=False, scheme_seqs=dna_seqs,
                       scheme_kw={})),
        ("pairs", dict(pairs=dna_chunk, traceback=True, scheme_seqs=dna_seqs,
                       scheme_kw={})),
    ]
    ranks = 4
    t0 = time.perf_counter()
    gloo = spawn_ranks(ranks, gloo_jobs, timeout=600)
    log(f"phase 2: {ranks} gloo ranks on one card: spawned, ran and joined "
        f"in {time.perf_counter() - t0:.3f} s")
    m_blocked = len(blocked_kw["seq_1"])
    bounds = linear_tb.block_bounds(m_blocked, len(blocked_kw["seq_2"]))
    blocked_strips = sum(
        -(-(hi - lo) // min(seqpar.DEFAULT_BLOCK_ROWS, hi - lo))
        for lo, hi in zip(bounds, bounds[1:])
    )
    gloo_exchange = []
    for rank, answers in enumerate(gloo):
        costs, blosum, blocked, pairs_c, pairs_tb = answers
        for label, ans in (("50000^2 DNA", costs), ("20000^2 BLOSUM62", blosum)):
            nblocks = -(-len((big_pair if "DNA" in label else blosum_pair)[0])
                        // seqpar.DEFAULT_BLOCK_ROWS)
            if ans["out"] != world1_cost[label][0] or (
                ans["launches"]["strip_fill_block"] != nblocks
            ):
                raise SystemExit(f"phase 2 failed: gloo rank {rank} "
                                 f"sharded_pair_cost {label}: {ans['out']}, "
                                 f"launches {ans['launches']}")
        cost_b, s1a, mid, s2a = blocked["out"]
        got_r = blocked_want._replace(
            seq_1_aligned=s1a, middle_part=mid, seq_2_aligned=s2a, cost=cost_b,
            score=final_cost_to_score(cost=cost_b, m=m_blocked,
                                      n=len(blocked_kw["seq_2"]),
                                      max_score=resolve_scheme(
                                          blocked_kw["seq_1"],
                                          blocked_kw["seq_2"]).max_score),
        )
        if got_r != blocked_want or str(got_r) != str(blocked_want) or (
            blocked["launches"]["strip_fill_block"] != blocked_strips
        ):
            raise SystemExit(f"phase 2 failed: gloo rank {rank} align_blocked"
                             f"(mesh=) 20000^2: launches {blocked['launches']}")
        for with_tb, ans in ((False, pairs_c), (True, pairs_tb)):
            want = [fields(r) for r in chunk_results["dna", with_tb][0]]
            if [tuple(x) for x in ans["out"]] != want:
                raise SystemExit(f"phase 2 failed: gloo rank {rank} align_pairs"
                                 f"(mesh=) DNA chunk traceback={with_tb}")
        for ans in answers:
            for name, k in ans["launches"].items():
                main_launches[name] += k
            census.update(ans["census"])
        gloo_exchange.append(costs["shift_s"])
    log(f"phase 2: {ranks} gloo ranks: sharded_pair_cost 50000^2 DNA and "
        f"20000^2 BLOSUM62 = the world of one on every rank, "
        f"{-(-50_000 // seqpar.DEFAULT_BLOCK_ROWS)} and "
        f"{-(-20_000 // seqpar.DEFAULT_BLOCK_ROWS)} strip launches a rank; "
        f"align_blocked(mesh=) 20000^2: strings, cost, score and report bytes "
        f"= the unsharded blocked path, {blocked_strips} strip launches a rank "
        f"({len(bounds) - 1} checkpoint blocks); align_pairs(mesh=) DNA chunk "
        f"both modes = unsharded; seconds a job on rank 0: "
        f"{[round(a['seconds'], 3) for a in gloo[0]]}")

    # The batch CLI across processes: --shard (an NCCL world of one), and
    # --distributed over 2 gloo processes on the card, dealt chunks (parts)
    # and, with --shard, as one host of 2 lockstep ranks: the merged output
    # is the single-process TSV, byte for byte.
    cli_want = outs["cuda"][0]
    with tempfile.TemporaryDirectory() as tmp:
        tsv = Path(tmp) / "pairs.tsv"
        tsv.write_text("".join(f"{a}\t{b}\n" for a, b in cli_pairs))
        base = [sys.executable, "-m", "globalign_tpu_torch.batch_cli",
                "--pairs_tsv", str(tsv), "--with_traceback", "--cigar"]

        def run_cli(cmds, label):
            procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for cmd in cmds]
            try:
                errs = [proc.communicate(timeout=600)[1] for proc in procs]
            finally:
                for proc in procs:
                    proc.kill()
            for proc, err in zip(procs, errs):
                if proc.returncode != 0:
                    raise SystemExit(f"phase 2 failed: batch_cli {label}: "
                                     f"{err[-2000:]}")

        out = Path(tmp) / "shard.tsv"
        run_cli([base + ["-o", str(out), "--shard"]], "--shard")
        if out.read_bytes() != cli_want:
            raise SystemExit("phase 2 failed: batch_cli --shard TSV differs")
        for extra, label in (([], "--distributed"),
                             (["--shard"], "--distributed --shard")):
            out = Path(tmp) / f"dist{len(extra)}.tsv"
            store = f"file://{Path(tmp) / f'store{len(extra)}'}"
            run_cli([
                base + ["-o", str(out), "--distributed", "--backend", "gloo",
                        "--coordinator_address", store, "--num_processes",
                        "2", "--process_id", str(k), "--chunk_pairs", "128",
                        *extra]
                for k in range(2)
            ], label)
            parts = sorted(Path(tmp).glob(f"{out.name}*"))
            rows = [ln for part in parts if not part.name.endswith(".jsonl")
                    for ln in part.read_text().splitlines(keepends=True)]
            merged = "".join(sorted(rows, key=lambda ln: int(ln.split("\t")[0])))
            if merged.encode() != cli_want:
                raise SystemExit(f"phase 2 failed: batch_cli {label} parts "
                                 f"differ from the single-process TSV")
            log(f"phase 2: batch_cli {label} over 2 gloo processes on the "
                f"card: {[p.name for p in parts]} merge to the single-process "
                f"TSV, byte for byte")
    log("phase 2: batch_cli --shard (NCCL world of one): TSV = the "
        "single-process TSV, byte for byte")

    # The anti-diagonal split (TPU kernel #9's entry point) on the long
    # pairs: the JAX bench's wave arm at 10 000^2 (the 10 000^2 DNA pair
    # above; the default DNA scheme is the bench's) and the 50 000^2 DNA
    # pair: one wave_split launch a call, equal to cost() (the row split)
    # and, at 10 000^2, to the direct cost-only fill.
    wave_main = {}
    for label, (s1, s2) in (
        ("10000^2 DNA", (long_runs[0]["seq_1"], long_runs[0]["seq_2"])),
        ("50000^2 DNA", big_pair),
    ):
        aligner = GotohAligner(resolve_scheme(s1, s2), device="cuda")
        prm = fill_wave.uniform_scheme_params(aligner.scheme.costing.values,
                                              aligner.gap_id)
        enc = (aligner._encode(s1), aligner._encode(s2), *prm,
               aligner.gap_open, len(s1), len(s2))
        torch.cuda.synchronize()
        reset_counts()
        c = int(fill_wave.wave_split_fill_cost(*enc))
        counts = read_counts()
        add_main(counts)
        split_c = aligner.cost(s1, s2)
        direct_c = split_c
        if len(s1) <= 10_000:
            direct, _ = aligner._batch_fill(s1, s2, want_moves=False)
            direct_c = int(direct.min())
        if c != split_c or c != direct_c or counts != launches(wave_frontiers=1):
            raise SystemExit(f"phase 2 failed: wave_split_fill_cost {label} {c}, "
                             f"cost() {split_c}, direct {direct_c}, launches "
                             f"{counts}")
        wave_main[label] = (enc, aligner, (s1, s2))
        log(f"phase 2: wave_split_fill_cost {label} (params {prm}, go "
            f"{aligner.gap_open}): {c} = cost() (the row split)"
            f"{' = the direct fill' if len(s1) <= 10_000 else ''}; launches "
            f"{counts}")

    # batch_final3_dual (TPU kernel #11's entry points) on the DNA chunk's
    # two widest buckets, one set each, padded to one shape and cut to one
    # count: one launch a call, every pair equal to align_pairs(with_
    # traceback=False).
    dna_pairs = chunks["dna"][0]
    dna_scheme = resolve_scheme(*("".join(s) for s in zip(*dna_pairs)))
    groups = {}
    for k, (a, b) in enumerate(dna_pairs):
        groups.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                          []).append(k)
    widest = sorted(groups, key=lambda key: (key[1], key[0]))[-2:]
    per_set = min(len(groups[key]) for key in widest)
    dual_ids = [groups[key][:per_set] for key in widest]
    mm = max(key[0] for key in widest)
    nn = max(key[1] for key in widest)
    dual_args = (
        torch.from_numpy(np.stack([
            [encode_padded(dna_scheme.alphabet, dna_pairs[k][0], mm) for k in ids]
            for ids in dual_ids])).to(dev),
        torch.from_numpy(np.stack([
            [encode_padded(dna_scheme.alphabet, dna_pairs[k][1], nn) for k in ids]
            for ids in dual_ids])).to(dev),
        torch.from_numpy(np.ascontiguousarray(dna_scheme.costing.values,
                                              dtype=np.int32)).to(dev),
        dna_scheme.alphabet.gap_id, dna_scheme.gap_open_cost,
        [[len(dna_pairs[k][0]) for k in ids] for ids in dual_ids],
        [[len(dna_pairs[k][1]) for k in ids] for ids in dual_ids],
    )
    torch.cuda.synchronize()
    reset_counts()
    dual_final3 = fill_batch.batch_final3_dual(*dual_args)
    counts = read_counts()
    add_main(counts)
    dual_main_launches = (counts["batch_final3"] + counts["batch_moves"]
                          + counts["gotoh_tile"])
    want_costs = [[chunk_results["dna", False][0][k].cost for k in ids]
                  for ids in dual_ids]
    if dual_final3.min(-1).values.tolist() != want_costs or counts != launches(
        batch_final3=1
    ):
        raise SystemExit(f"phase 2 failed: batch_final3_dual on the DNA chunk's "
                         f"buckets {widest}: launches {counts}")
    log(f"phase 2: batch_final3_dual on the DNA chunk's buckets {widest}, "
        f"{per_set} pairs each, padded to {mm} x {nn}: every pair = align_pairs"
        f"(with_traceback=False); launches {counts}")

    # The reference-layout package (globalign_tpu_torch.compat) as code
    # written against the reference calls it: no device argument, so the
    # card; every result = the port's API with device="cpu".  Its own rng,
    # so the data of the other legs stays as it was.
    from globalign_tpu_torch import cli as torch_cli
    from globalign_tpu_torch import compat

    crng = np.random.default_rng(SEED + 9)
    goldens = [(kw, golden) for kw, golden in runs if golden is not None]
    want_golden = [find_global_alignment(**kw, device="cpu") for kw, _ in goldens]
    torch.cuda.synchronize()
    reset_counts()
    got = [compat.globaligner.find_global_alignment(**kw) for kw, _ in goldens]
    counts = read_counts()
    add_main(counts)
    if [str(r) for r in got] != [str(w) for w in want_golden] or (
        got != want_golden
        or counts != design(*[(1, len(kw["seq_1"]), len(kw["seq_2"]), True,
                               "batch_moves") for kw, _ in goldens],
                            walk_block=len(goldens))
        or [(r.score, r.cost) for r in got] != [g for _, g in goldens]
    ):
        raise SystemExit(f"phase 2 failed: compat goldens, launches {counts}")
    log(f"phase 2: compat goldens: {len(goldens)} find_global_alignment calls with "
        f"no device = device='cpu' (strings, cost, score, str); launches "
        f"{counts}")

    # Two pairs at the reference's input limit (m * n < 2e7), with no
    # device argument: one gotoh_fill moves launch and one walk a pair.
    s1 = random_seq(crng, DNA, 4472)
    limit_runs = {"dna 4472 x 4472": dict(seq_1=s1, seq_2=mutate(crng, s1, DNA))}
    s1 = random_seq(crng, PROTEIN, 4472)
    limit_runs["blosum62 4472 x 4471"] = dict(
        seq_1=s1, seq_2=mutate(crng, s1, PROTEIN)[:4471],
        scoring_mat_name="BLOSUM62")
    compat_ms = {}
    for label, kw in limit_runs.items():
        want_r = find_global_alignment(**kw, device="cpu")
        torch.cuda.synchronize()
        reset_counts()
        r = compat.globaligner.find_global_alignment(**kw)
        counts = read_counts()
        add_main(counts)
        aligner = GotohAligner(
            validate_and_transform_args(**kw).scheme, device="cuda")
        reset_counts()
        c = aligner.cost(kw["seq_1"], kw["seq_2"])
        cost_counts = read_counts()
        add_main(cost_counts)
        if r != want_r or str(r) != str(want_r) or r.cost != c or (
            counts != design((1, len(kw["seq_1"]), len(kw["seq_2"]), True,
                              "batch_moves"), walk_block=1)
        ):
            raise SystemExit(f"phase 2 failed: compat {label}: cost {r.cost}, "
                             f"cpu {want_r.cost}, cost() {c}, launches {counts}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compat.find_global_alignment(**kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        compat_ms[label] = times
        log(f"phase 2: compat {label}: score {r.score} cost {r.cost} = "
            f"device='cpu' (strings, cost, score, str) = cost() on the card "
            f"(launches {cost_counts}); launches "
            f"{counts}; end to end on {card}: {', '.join(f'{t:.3f}' for t in times)} ms")

    # The two caps: start's validation refuses the reference's limit, the
    # port's find_global_alignment runs past it.
    s1 = random_seq(crng, DNA, 4473)
    past = dict(seq_1=s1, seq_2=mutate(crng, s1, DNA)[:4472])
    try:
        compat.start.validate_and_transform_args(**past)
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise SystemExit("phase 2 failed: compat.start accepted 4473 x 4472")
    if "too long" not in refusal:
        raise SystemExit(f"phase 2 failed: compat.start refused with {refusal!r}")
    compat.start.validate_and_transform_args(**limit_runs["dna 4472 x 4472"])
    reset_counts()
    r = compat.find_global_alignment(**past)
    counts = read_counts()
    add_main(counts)
    past_cost = GotohAligner(validate_and_transform_args(**past).scheme,
                             device="cuda").cost(past["seq_1"], past["seq_2"])
    if r.cost != past_cost or counts != design(
            (1, len(past["seq_1"]), len(past["seq_2"]), True, "batch_moves"),
            walk_block=1):
        raise SystemExit(f"phase 2 failed: compat find_global_alignment "
                         f"4473 x 4472: cost {r.cost}, cost() {past_cost}, "
                         f"launches {counts}")
    log(f"phase 2: compat.start.validate_and_transform_args accepts 4472 x "
        f"4472 and refuses 4473 x 4472 ({refusal!r}); compat "
        f"find_global_alignment runs 4473 x 4472: cost {r.cost} = cost(); "
        f"launches {counts}")

    # globaligner.main on the card = the port's CLI with --device cpu.
    s1 = random_seq(crng, PROTEIN, 1500)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = Path(tmp) / "pair.fasta"
        fasta.write_text(f">a\n{s1}\n>b\n{mutate(crng, s1, PROTEIN)[:1400]}\n")
        argv = ["-i", str(fasta), "--scoring_mat_name", "BLOSUM62"]
        torch_cli.main(argv + ["--device", "cpu", "-o", f"{tmp}/cpu.txt"])
        reset_counts()
        compat.globaligner.main(argv + ["-o", f"{tmp}/card.txt"])
        counts = read_counts()
        add_main(counts)
        report = Path(f"{tmp}/card.txt").read_bytes()
        if report != Path(f"{tmp}/cpu.txt").read_bytes() or (
            counts != design((1, 1500, 1400, True, "batch_moves"), walk_block=1)
        ):
            raise SystemExit(f"phase 2 failed: compat main report differs, "
                             f"launches {counts}")
    log(f"phase 2: compat globaligner.main 1500 x 1400 BLOSUM62 (FASTA) on the "
        f"card: report bytes ({len(report)}) = cli.main --device cpu; "
        f"launches {counts}")

    # dp_compat's interpreted fill (host lists, never the card) = the card.
    s1 = random_seq(crng, DNA, 200)
    s2 = mutate(crng, s1, DNA)
    r = compat.find_global_alignment(seq_1=s1, seq_2=s2)
    costing = r.costing_mat
    dp = compat.globaligner.make_dp_array(
        s1, s2, costing, compat.start.get_max_val(costing), r.gap_open_cost)
    compat.globaligner.dp_array_forward(dp, s1, s2, costing, r.gap_open_cost)
    dp_back = compat.globaligner.dp_array_backward(
        dp, s1, s2, costing, r.gap_open_cost)
    if dp_back[3] != r.cost:
        raise SystemExit(f"phase 2 failed: dp_compat cost {dp_back[3]}, card "
                         f"{r.cost}")
    log(f"phase 2: compat dp_compat 200 x 200: cost {dp_back[3]} = the card's; "
        f"alignment strings "
        f"{'equal' if dp_back[:3] == tuple(r[:3]) else 'differ (a tie)'}")
    log(f"phase 2: compat leg end to end on {card}, ms: "
        + json.dumps(compat_ms))
    log(f"phase 2: launches on the main paths: {main_launches}")
    idle = [k for k in counters
            if k != "batch_last_rows" and not main_launches[k]]
    if idle:  # batch_last_rows is gotoh_fill's, counted with batch_moves
        raise SystemExit(f"phase 2 failed: kernels never launched on the "
                         f"main paths: {idle}")
    census_total = sum(census.values())
    if census_total != (main_launches["batch_moves"]
                        + main_launches["batch_last_rows"]
                        + main_launches["strip_fill_block"]):
        raise SystemExit(f"phase 2 failed: the gotoh_fill census counts "
                         f"{census_total} launches, the wrappers "
                         f"{main_launches}")
    log(f"phase 2: gotoh_fill launches on the main paths by (mode, B, M, N): "
        + "; ".join(f"{k}: {v}" for k, v in sorted(census.items())))

    # -- phase 3: times -------------------------------------------------
    def timed_call(fn) -> float:
        """Seconds of one synchronised call on the host clock."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def cuda_ms(fn, reps: int) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    kernel_ms = plain_ms = fill_size = None
    align_split = {}  # size -> the single-pair align's parts, ms
    tile_fill = {}  # size -> gotoh_tile and gotoh_fill, codes and cost only
    for size in (4096, 8000):
        s1 = random_seq(rng, DNA, size)
        s2 = mutate(rng, s1, DNA)
        scheme = resolve_scheme(s1, s2)
        args = to_dev(fill_args(scheme, [(s1, s2)]))
        cells = size * size
        # gotoh_fill (the route set aside) and gotoh_tile in turns: fill,
        # tile, tile, fill
        turns = {}
        for arm in ("fill", "tile", "tile", "fill"):
            for moves in (True, False):
                if arm == "fill":
                    with gotoh_fill_only(fill_tile):
                        t = cuda_ms(lambda: fill_cuda.batch_moves(
                            *args, want_moves=moves), 5)
                else:
                    t = cuda_ms(lambda: fill_tile.gotoh_tile(
                        *args, want_moves=moves), 5)
                turns.setdefault((arm, moves), []).append(t)
        k_ms, c_ms, t_ms, tc_ms = (float(np.mean(turns[k])) for k in (
            ("fill", True), ("fill", False), ("tile", True), ("tile", False)))
        shape = fill_tile.plan([(size, len(s2))], True, sms)
        tile_fill[size] = dict(
            gotoh_tile_ms=t_ms, gotoh_tile_cost_only_ms=tc_ms,
            gotoh_fill_ms=k_ms, gotoh_fill_cost_only_ms=c_ms,
            shape=list(shape), shape_cost_only=list(
                fill_tile.plan([(size, len(s2))], False, sms)),
            path_tiles=fill_tile.model([(size, len(s2))], shape, True, sms).path_tiles,
            turns={f"{a} {'codes' if mv else 'cost only'}": v
                   for (a, mv), v in turns.items()})
        log(f"phase 3: fill {size}x{size} on {card}: gotoh_tile {t_ms:.4f} ms "
            f"with codes (H, W) = {shape}, {tc_ms:.4f} ms cost only; "
            f"gotoh_fill {k_ms:.4f} / {c_ms:.4f} ms (turns fill, tile, tile, "
            f"fill: {tile_fill[size]['turns']})")
        p_ms = cuda_ms(
            lambda: fill_rows.row_fill(
                args[0][0], args[1][0], args[2], args[3], args[4]
            ),
            2,
        )
        log(f"phase 3: fill {size}x{size} on {card}: gotoh_fill {k_ms:.4f} ms "
            f"({cells / k_ms / 1e6:.4f} GCUPS), cost-only kernel "
            f"{c_ms:.4f} ms ({cells / c_ms / 1e6:.4f} GCUPS), plain row scan "
            f"on the card {p_ms:.4f} ms ({cells / p_ms / 1e6:.4f} GCUPS)")

        # align end to end, then its route step by step: the fill and the
        # walk kernel in device time (CUDA events), the one fetch of final3
        # and the tape and the render on the host clock; beside them the
        # route the walk kernel replaced (the code matrix to the host and
        # the host walk, ops/traceback.traceback_moves).
        aligner = GotohAligner(scheme, device="cuda")
        aligner.align(s1, s2)  # warm-up
        with gotoh_fill_only(fill_tile):  # the route before gotoh_tile
            aligner.align(s1, s2)
            old_e2e = 1e3 * float(np.median([
                timed_call(lambda: aligner.align(s1, s2)) for _ in range(3)]))
        parts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aligner.align(s1, s2)
            total = time.perf_counter() - t0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            final3, moves = fill_cuda.batch_moves(*args)
            ev[1].record()
            j_dev = torch.full((1,), size, dtype=torch.int32, device=dev)
            level = final3[0].argmin().to(torch.int32).reshape(1)
            ev[2].record()
            ops, count, j_exit, _ = linear_tb.walk_block(moves, [size], j_dev,
                                                         level)
            ev[3].record()
            ev[3].synchronize()
            t1 = time.perf_counter()
            ints, tape = linear_tb.fetch_walk(
                [final3[0].min().reshape(1), count, j_exit], ops[0])
            linear_tb.render_walk(tape[: int(ints[1])], int(ints[2]), s1, s2)
            t2 = time.perf_counter()
            traceback_moves(moves[0].cpu().numpy(), s1, s2,
                            final3[0].cpu().numpy())
            parts.append((1e3 * total, ev[0].elapsed_time(ev[1]),
                          ev[2].elapsed_time(ev[3]), 1e3 * (t2 - t1),
                          1e3 * (time.perf_counter() - t2)))
        a_ms, f_ms, w_ms, r_ms, old_ms = (float(np.median(x)) for x in zip(*parts))
        align_split[size] = dict(end_to_end_ms=a_ms, fill_ms=f_ms, walk_ms=w_ms,
                                 fetch_render_ms=r_ms, host_walk_route_ms=old_ms,
                                 gotoh_fill_route_ms=old_e2e)
        log(f"phase 3: align {size}x{size} on {card}: end to end "
            f"{a_ms:.4f} ms ({cells / a_ms / 1e6:.4f} GCUPS; on gotoh_fill, "
            f"the route before, {old_e2e:.4f} ms); fill "
            f"{f_ms:.4f} ms, walk kernel {w_ms:.4f} ms (device), fetch + "
            f"render {r_ms:.4f} ms (host); the route it replaced, the codes "
            f"to the host + the host walk: {old_ms:.4f} ms")
        kernel_ms, plain_ms, fill_size, cost_only_ms = k_ms, p_ms, size, c_ms

    # The last-row mode, injected (a checkpoint fill), beside the plain
    # row scan on the card.
    s1 = random_seq(rng, DNA, 4096)
    s2 = mutate(rng, s1, DNA)
    args = to_dev(fill_args(resolve_scheme(s1, s2), [(s1, s2)]))
    row0 = fill_cuda.batch_last_rows(*args)
    c0 = torch.full((1,), args[4], dtype=torch.int32, device=dev)
    with gotoh_fill_only(fill_tile):
        last_ms = cuda_ms(
            lambda: fill_cuda.batch_last_rows(*args, row0=row0, col0y_top=c0), 5
        )
    tile_last_ms = cuda_ms(lambda: fill_tile.gotoh_tile(
        *args, want_moves=False, rows=[[4096]], row0=row0, col0y_top=c0), 5)
    plain_last_ms = cuda_ms(
        lambda: fill_rows.row_fill(
            args[0][0], args[1][0], args[2], args[3], args[4], row0=row0[0],
            want_moves=False,
        ),
        2,
    )
    log(f"phase 3: injected last-row fill 4096x4096 on {card}: gotoh_fill "
        f"{last_ms:.4f} ms ({4096 * 4096 / last_ms / 1e6:.4f} GCUPS), "
        f"gotoh_tile {tile_last_ms:.4f} ms, plain row scan on the card "
        f"{plain_last_ms:.4f} ms")

    # Blocked align, phase by phase, beside the full-matrix route; the
    # split cost beside the direct cost-only fill; the walk kernel beside
    # the plain walk.
    def median_s(fn, reps: int = 3) -> float:
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return float(np.median(out))

    walk_ms = plain_walk_ms = walk_steps = walk_path = None
    blocked_dev = {}  # size -> (checkpoint pass, replay fills) device ms
    blocked_rec = {}  # size -> the checkpoint pass and a replay, both kernels
    split_rec = {}  # size -> the split on gotoh_tile and on gotoh_fill
    for size in (10_000, 20_000):
        s1 = random_seq(rng, DNA, size)
        s2 = mutate(rng, s1, DNA)
        cells = size * size
        scheme = resolve_scheme(s1, s2)
        blocked = GotohAligner(scheme, device="cuda")
        full = GotohAligner(scheme, moves_budget_bytes=1 << 40, device="cuda")
        enc = (blocked._encode(s1), blocked._encode(s2), blocked.cost_mat,
               blocked.gap_id, blocked.gap_open, s1, s2)
        budget = blocked.moves_budget_bytes
        blocked.align(s1, s2)  # warm-up
        parts = []
        for _ in range(3):
            marks = []

            def on_phase(label):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((label, ev, time.perf_counter()))

            torch.cuda.synchronize()
            on_phase("start")
            linear_tb.align_blocked(
                *enc, block_moves_bytes=budget, on_phase=on_phase
            )
            dev_ms = {"checkpoints": 0.0, "fill": 0.0, "walk": 0.0,
                      "fetch": 0.0}
            for (_, e0, _), (label, e1, _) in zip(marks, marks[1:]):
                if label in dev_ms:
                    dev_ms[label] += e0.elapsed_time(e1)
            host = {label: t for label, _, t in marks}
            last_walk = [t for label, _, t in marks if label == "walk"][-1]
            parts.append((
                dev_ms["checkpoints"], dev_ms["fill"], dev_ms["walk"],
                dev_ms["fetch"],
                1e3 * (last_walk - host["start"]),
                1e3 * (host["fetch"] - last_walk),
                1e3 * (host["assembled"] - host["fetch"]),
                1e3 * (host["assembled"] - host["start"]),
            ))
        ck, fi, wa, fe, enq, wait, asm, tot = (
            float(np.median(c)) for c in zip(*parts)
        )
        blocked_dev[size] = (ck, fi)
        bounds = linear_tb.block_bounds(size, len(s2), block_moves_bytes=budget)
        nblocks = len(bounds) - 1

        # The checkpoint pass as one gotoh_tile launch (align_blocked's)
        # beside the pass as it was, a gotoh_fill last-rows launch a block
        # seeded from the block above, in turns; both give the same rows.
        b_row0, b_col0 = default_boundary(*enc[:5])
        c0_top = b_col0[2].clone()
        c0_top[0] = blocked.gap_open

        def ck_per_block():
            rows = [b_row0[None]]
            for i0, i1 in zip(bounds, bounds[1:]):
                rows.append(fill_cuda.batch_last_rows(
                    enc[0][None, i0 : i1 + 1], enc[1][None], *enc[2:5],
                    [i1 - i0], [len(s2)], row0=rows[-1],
                    col0y_top=c0_top[i0 : i0 + 1]))
            return torch.cat(rows[1:])

        def ck_one_launch():
            return fill_tile.checkpoint_rows(*enc[:5], bounds[1:])

        ck_turns = {"one gotoh_tile launch": [], "gotoh_fill a block": []}
        for arm in ("one gotoh_tile launch", "gotoh_fill a block",
                    "gotoh_fill a block", "one gotoh_tile launch"):
            if arm == "gotoh_fill a block":
                with gotoh_fill_only(fill_tile):
                    ck_turns[arm].append(cuda_ms(ck_per_block, 3))
            else:
                ck_turns[arm].append(cuda_ms(ck_one_launch, 3))
        with gotoh_fill_only(fill_tile):
            old_rows = ck_per_block()
        if not torch.equal(old_rows, ck_one_launch()):
            raise SystemExit(f"phase 3 failed: checkpoint rows at {size}: "
                             "one launch != a launch a block")
        ck_new = float(np.mean(ck_turns["one gotoh_tile launch"]))
        ck_old = float(np.mean(ck_turns["gotoh_fill a block"]))
        ck_shape = fill_tile.plan([(size, len(s2))], False, sms)
        ck_model = fill_tile.model([(size, len(s2))], ck_shape, False, sms)
        # A replay fill (the second block, injected) on gotoh_fill and on
        # gotoh_tile at every (H, W).
        i0, i1 = bounds[1], bounds[2]
        rp_args = (enc[0][None, i0 : i1 + 1].contiguous(), enc[1][None],
                   *enc[2:5], [i1 - i0], [len(s2)])
        rp_inj = dict(row0=old_rows[0:1], col0y_top=c0_top[i0 : i0 + 1])
        with gotoh_fill_only(fill_tile):
            rp_fill = cuda_ms(lambda: fill_cuda.batch_moves(*rp_args, **rp_inj), 3)
            want_rp = fill_cuda.batch_moves(*rp_args, **rp_inj)
        rp_tile = {}
        for shape in fill_tile.SHAPES:
            rp_tile[f"H={shape[0]} W={shape[1]}"] = cuda_ms(
                lambda: fill_tile.gotoh_tile(*rp_args, shape=shape, **rp_inj), 3)
            got_rp = fill_tile.gotoh_tile(*rp_args, shape=shape, **rp_inj)
            if not (torch.equal(got_rp[0], want_rp[0])
                    and torch.equal(got_rp[1], want_rp[1])):
                raise SystemExit(f"phase 3 failed: replay fill {shape} != "
                                 "gotoh_fill")
        blocked_rec[size] = dict(
            checkpoint_pass_ms=ck_new, checkpoint_pass_gotoh_fill_ms=ck_old,
            checkpoint_turns_ms=ck_turns, checkpoint_shape=list(ck_shape),
            checkpoint_path_tiles=ck_model.path_tiles, blocks=nblocks,
            replay_shape=[i1 - i0, len(s2)], replay_gotoh_fill_ms=rp_fill,
            replay_gotoh_tile_ms=rp_tile,
            replay_route_shape=list(fill_tile.plan([(i1 - i0, len(s2))], True, sms)),
            replay_path_tiles={
                f"H={sh[0]} W={sh[1]}": fill_tile.model(
                    [(i1 - i0, len(s2))], sh, True, sms).path_tiles
                for sh in fill_tile.SHAPES},
        )
        log(f"phase 3: checkpoint pass {size}x{len(s2)} ({nblocks} blocks) on "
            f"{card}: one gotoh_tile launch (H, W) = {ck_shape}, "
            f"{ck_model.path_tiles} tiles on the path: {ck_new:.4f} ms; a "
            f"gotoh_fill launch a block: {ck_old:.4f} ms (turns {ck_turns}); "
            f"rows equal. Replay fill {i1 - i0} x {len(s2)} injected: "
            f"gotoh_fill {rp_fill:.4f} ms, gotoh_tile "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in rp_tile.items())
            + " (codes and final3 equal)")
        b_ms = 1e3 * median_s(lambda: blocked.align(s1, s2))
        full.align(s1, s2)  # warm-up
        f_ms = 1e3 * median_s(lambda: full.align(s1, s2))
        full_args = to_dev(fill_args(scheme, [(s1, s2)]))
        ff_ms = cuda_ms(lambda: fill_cuda.batch_moves(*full_args), 3)
        log(f"phase 3: blocked align {size}x{len(s2)} ({nblocks} blocks) on "
            f"{card}: end to end {b_ms:.4f} ms ({cells / b_ms / 1e6:.4f} "
            f"GCUPS); align_blocked {tot:.4f} ms; device: checkpoint pass "
            f"{ck:.4f} ms + replay fills {fi:.4f} ms + walks {wa:.4f} ms + "
            f"tape fetch {fe:.4f} ms; host: enqueue {enq:.4f} ms, wait for "
            f"the device and fetch {wait:.4f} ms, assembly {asm:.4f} ms")
        log(f"phase 3: full-matrix align {size}x{len(s2)} on {card}: end to "
            f"end {f_ms:.4f} ms ({cells / f_ms / 1e6:.4f} GCUPS); fill "
            f"{ff_ms:.4f} ms")

        direct_args = to_dev(fill_args(scheme, [(s1, s2)]))
        split_ms = cuda_ms(lambda: fill_split.split_fill_cost(*enc[:5]), 3)
        with gotoh_fill_only(fill_tile):
            split_fill_ms = cuda_ms(
                lambda: fill_split.split_fill_cost(*enc[:5]), 3)
        split_shape = fill_tile.plan([(size - size // 2, len(s2))] * 2, False, sms)
        split_rec[size] = dict(
            ms=split_ms, gotoh_fill_ms=split_fill_ms, shape=list(split_shape),
            routed=fill_tile.route(2, size - size // 2, len(s2), False, sms),
            path_tiles=fill_tile.model([(size - size // 2, len(s2))] * 2,
                                       split_shape, False, sms).path_tiles)
        direct_ms = cuda_ms(
            lambda: fill_cuda.batch_moves(*direct_args, want_moves=False), 3
        )
        cost_ms = 1e3 * median_s(lambda: blocked.cost(s1, s2))
        log(f"phase 3: cost {size}x{len(s2)} on {card}: split {split_ms:.4f} "
            f"ms (one 2-pair launch + join; on gotoh_fill {split_fill_ms:.4f} "
            f"ms), direct cost-only fill {direct_ms:.4f} ms; cost() end to "
            f"end {cost_ms:.4f} ms")

        if size == 10_000:  # the walk over a whole 10 000-row matrix
            final3, moves = fill_cuda.batch_moves(*full_args)
            level = final3.argmin(-1).to(torch.int32)
            j_dev = torch.full((1,), len(s2), dtype=torch.int32, device=dev)
            walk_ms = cuda_ms(
                lambda: linear_tb.walk_block(moves, [size], j_dev, level), 3
            )
            moves_cpu, j_cpu, level_cpu = moves.cpu(), j_dev.cpu(), level.cpu()
            t0 = time.perf_counter()
            want = linear_tb.walk_block(moves_cpu, [size], j_cpu, level_cpu)
            plain_walk_ms = 1e3 * (time.perf_counter() - t0)
            walk_steps = int(want[1][0])
            walk_path = (want[0][0, :walk_steps].numpy(), size, len(s2),
                         len(s2) + 1)
            got = linear_tb.walk_block(moves, [size], j_dev, level)
            err = max(abs_err(g, w) for g, w in zip(got, want))
            walk_err = max(walk_err, err)
            log(f"phase 3: walk {size}x{len(s2)} ({int(want[1][0])} steps) on "
                f"{card}: kernel {walk_ms:.4f} ms, plain walk on the host "
                f"{plain_walk_ms:.4f} ms; ops, count, j_exit, level_exit max "
                f"abs err {err}")
            if err != 0:
                raise SystemExit("phase 3 failed: walk_block != plain walk")

    # cost(): the split beside the direct cost-only fill, end to end on the
    # host clock (tokens to the int the caller gets), from a golden-sized
    # pair up, on both sides of SPLIT_MIN_ROWS.
    for size in (24, 512, 1023, 1024, 2048, 4096):
        s1 = random_seq(rng, DNA, size)
        s2 = mutate(rng, s1, DNA)
        aligner = GotohAligner(resolve_scheme(s1, s2), device="cuda")

        def split_cost():
            return int(fill_split.split_fill_cost(
                aligner._encode(s1), aligner._encode(s2), aligner.cost_mat,
                aligner.gap_id, aligner.gap_open,
            ))

        def direct_cost():
            final3, _ = aligner._batch_fill(s1, s2, want_moves=False)
            return int(final3.min())

        if split_cost() != direct_cost():
            raise SystemExit(f"phase 3 failed: split != direct at {size}")
        reps = 21 if size < 4096 else 5
        sp_ms = 1e3 * median_s(split_cost, reps)
        di_ms = 1e3 * median_s(direct_cost, reps)
        co_ms = 1e3 * median_s(lambda: aligner.cost(s1, s2), reps)
        log(f"phase 3: cost {size}x{len(s2)} on {card}: split {sp_ms:.4f} "
            f"ms, direct {di_ms:.4f} ms, cost() {co_ms:.4f} ms (split from "
            f"{SPLIT_MIN_ROWS} rows)")

    # -- phase 3, gotoh_tile: a tile's time, the crossover sweep ------------
    # A tile's time at each (H, W), with codes and cost only: a pair one
    # tile column wide (64 H x 32 W), whose 64 tiles run one after another.
    def dna_args(nb, m, n):
        pairs = [(random_seq(rng, DNA, m), random_seq(rng, DNA, n))
                 for _ in range(nb)]
        return to_dev(fill_args(dna_fill, pairs))

    tile_us = {}
    for height, width in fill_tile.SHAPES:
        col_args = dna_args(1, 64 * height, 32 * width)
        for moves in (True, False):
            t = cuda_ms(lambda: fill_tile.gotoh_tile(
                *col_args, want_moves=moves, shape=(height, width)), 5)
            tile_us[f"H={height} W={width}{' codes' if moves else ''}"] = (
                1e3 * t / 64)
    log(f"phase 3: gotoh_tile one tile column (64 H x 32 W, 64 tiles in a "
        f"chain) on {card}, us a tile: "
        + ", ".join(f"{k} {v:.4f}" for k, v in tile_us.items()))

    def path_model_ms(nb, m, n, shape, moves):
        """The critical path: its tiles x a tile's time (the column above)."""
        tiles = fill_tile.model([(m, n)] * nb, shape, moves, sms).path_tiles
        key = f"H={shape[0]} W={shape[1]}{' codes' if moves else ''}"
        return tiles, tiles * tile_us[key] / 1e3

    # The crossover sweep: B in {1, 2, 8} x {256^2, 1024^2, 4096^2, 8000^2},
    # a 3355 x 20 000 replay block, 20 000 x 512 and a short, wide 600 x
    # 20 000 block, with codes and cost only, on gotoh_fill and on gotoh_tile at every (H, W) (device time,
    # CUDA events; each tile shape's final3 and codes equal gotoh_fill's).
    sweep_points = [(nb, sz, sz) for nb in (1, 2, 8)
                    for sz in (256, 1024, 4096, 8000)]
    sweep_points += [(1, 3355, 20_000), (1, 20_000, 512), (1, 600, 20_000)]
    tile_sweep = []
    for nb, m, n in sweep_points:
        a = dna_args(nb, m, n)
        reps = 5 if nb * m * n < 1e8 else 3
        for moves in (True, False):
            with gotoh_fill_only(fill_tile):
                gf = cuda_ms(lambda: fill_cuda.batch_moves(*a, want_moves=moves),
                             reps)
                want_f3, want_mv = fill_cuda.batch_moves(*a, want_moves=moves)
            row = dict(batch=nb, m=m, n=n, codes=moves, gotoh_fill_ms=gf,
                       gotoh_tile_ms={}, path_model_ms={},
                       plan=list(fill_tile.plan([(m, n)] * nb, moves, sms)),
                       route=fill_tile.route(nb, m, n, moves, sms))
            for shape in fill_tile.SHAPES:
                key = f"H={shape[0]} W={shape[1]}"
                row["gotoh_tile_ms"][key] = cuda_ms(lambda: fill_tile.gotoh_tile(
                    *a, want_moves=moves, shape=shape), reps)
                row["path_model_ms"][key] = path_model_ms(nb, m, n, shape, moves)[1]
                got_f3, got_mv, _ = fill_tile.gotoh_tile(*a, want_moves=moves,
                                                         shape=shape)
                if not torch.equal(got_f3, want_f3) or (
                        moves and not torch.equal(got_mv, want_mv)):
                    raise SystemExit(f"phase 3 failed: gotoh_tile {shape} != "
                                     f"gotoh_fill at {nb} x {m} x {n}")
            best = min(row["gotoh_tile_ms"], key=row["gotoh_tile_ms"].get)
            row["best_tile"] = best
            tile_sweep.append(row)
            log(f"phase 3: tile sweep {nb} x {m} x {n} "
                f"{'codes' if moves else 'cost only'} on {card} (device time): "
                f"gotoh_fill {gf:.4f} ms; gotoh_tile "
                + ", ".join(f"{k} {v:.4f} ms (path model "
                            f"{row['path_model_ms'][k]:.4f})"
                            for k, v in row["gotoh_tile_ms"].items())
                + f"; best {best}, plan {row['plan']}, route "
                f"{'gotoh_tile' if row['route'] else 'gotoh_fill'}")
    wins = [(r["batch"], r["m"], r["n"], "codes" if r["codes"] else "cost")
            for r in tile_sweep
            if min(r["gotoh_tile_ms"].values()) < r["gotoh_fill_ms"]]
    log(f"phase 3: tile sweep: gotoh_tile (its best shape) faster than "
        f"gotoh_fill at {wins}")
    # The wide route's rule: a call's wide tail in one launch or a launch
    # a bucket.
    wide_rows = wide_sweep(card)

    # -- phase 3, batch serving -------------------------------------------
    # Each wrapper's launches are bracketed by CUDA events (device fill and
    # walk time); the host clock takes the call after a synchronise, and
    # align_pairs' phase_seconds its enqueue, fetch (wait + copy) and render.
    def timed(fn, spans):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out

        wrapper.launches = 0  # the wrappers count on their global name
        return wrapper

    def time_align_pairs(pairs, scheme, with_tb, reps=3):
        align_pairs(pairs, scheme=scheme, with_traceback=with_tb)  # warm-up
        rows = []
        for _ in range(reps):
            spans = {"fill": [], "walk": []}
            patched = (  # each launch under one wrapper's span
                [(fill_cuda, "batch_moves_ragged", "fill"),
                 (linear_tb, "walk_ragged", "walk")]
                if with_tb else [(fill_batch, "batch_final3_ragged", "fill")]
            )
            saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
            phases = {}
            try:
                for mod, name, kind in patched:
                    setattr(mod, name, timed(getattr(mod, name), spans[kind]))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                align_pairs(pairs, scheme=scheme, with_traceback=with_tb,
                            phase_seconds=phases)
                total = time.perf_counter() - t0
            finally:
                for mod, name, fn in saved:
                    setattr(mod, name, fn)
            rows.append((
                1e3 * total,
                sum(s.elapsed_time(e) for s, e in spans["fill"]),
                sum(s.elapsed_time(e) for s, e in spans["walk"]),
                {k: 1e3 * v for k, v in phases.items()},
            ))
        names = sorted({k for row in rows for k in row[3]})
        return [float(np.median(col)) for col in list(zip(*rows))[:3]] + [
            {k: float(np.median([row[3].get(k, 0.0) for row in rows]))
             for k in names}]

    def bucket_inputs(pairs, scheme):
        """align_pairs' buckets of ``pairs`` as fill arguments on the card."""
        groups = {}
        for a, b in pairs:
            key = (bucket_length(len(a)), bucket_length(len(b)))
            groups.setdefault(key, []).append((a, b))
        cost = torch.from_numpy(
            np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
        ).to(dev)
        out = []
        for (mm, nn), group in groups.items():
            ta = np.stack([encode_padded(scheme.alphabet, a, mm) for a, _ in group])
            tb = np.stack([encode_padded(scheme.alphabet, b, nn) for _, b in group])
            out.append((torch.from_numpy(ta).to(dev), torch.from_numpy(tb).to(dev),
                        cost, scheme.alphabet.gap_id, scheme.gap_open_cost,
                        [len(a) for a, _ in group], [len(b) for _, b in group]))
        return out

    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sm_hz = float(smi_clock) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hbm_bytes_s = 3.35e12  # H100 SXM HBM3

    # The card's best case for the fills' arithmetic and the walk's loads,
    # measured here by the probes of utils/peaks.py (checked first against
    # the plain row scan): the cell rate of a fill in registers at the
    # fewest int32 operations a cell needs on sm_90 (9 cost only, 23 with
    # codes: DPX fused add-min and 3-way min), and the clocks of one
    # dependent load from L1 and from L2.
    dna_scheme = resolve_scheme(DNA, DNA)
    peak = peaks.measure(
        dev, torch.from_numpy(np.asarray(dna_scheme.costing.values, np.int32)),
        dna_scheme.alphabet.gap_id, dna_scheme.gap_open_cost, SEED,
    )
    per_clock_sm = {
        mode: peak[f"{mode}_cells_s"] * peaks.CELL_OPS[mode] / (sms * sm_hz)
        for mode in peaks.CELL_OPS
    }
    log(f"phase 3: peaks on {card}: a fill's arithmetic in registers "
        f"{peak['cost_cells_s'] / 1e9:.4f} Gcells/s cost only "
        f"({per_clock_sm['cost']:.4f} int32 ops a clock an SM at "
        f"{peaks.CELL_OPS['cost']} a cell), {peak['moves_cells_s'] / 1e9:.4f}"
        f" Gcells/s with codes ({per_clock_sm['moves']:.4f} at "
        f"{peaks.CELL_OPS['moves']} a cell); DPX fused add-min "
        f"{peak['addmin_ops_s'] / (sms * sm_hz):.4f} a clock an SM; one "
        f"dependent load {peak['l1_load_clocks']:.2f} clocks from L1, "
        f"{peak['l2_load_clocks']:.2f} from L2, "
        f"{peak['smem_load_clocks']:.2f} from shared memory ({sms} SMs at "
        f"{smi_clock} MHz)")

    def bound(cells, mode, nbytes):
        """(least ms on this card, what bounds it): the cells at the peak
        cell rate of ``mode`` ("cost" or "moves"), bytes over the HBM
        rate."""
        t_ops = 1e3 * cells / peak[f"{mode}_cells_s"]
        t_bytes = 1e3 * nbytes / hbm_bytes_s
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def walk_bound(ops, i0, j0, ld, base=0):
        """(least ms, the old design's floor in ms, (sectors opened, other
        loads)) of one walk of ``ops`` from (i0, j0) over codes ``ld`` bytes
        a row from byte ``base``.  Every step's code load waits for the step
        before (column 0 loads nothing).  The least time: each load from
        shared memory, where the walk kernel stages its tiles, plus one L2
        latency for the first tile.  The old design's floor, of a kernel
        that read its codes where they lie: a load that opens a 32-byte
        sector the walk has not read (it never comes back to one) from L2,
        the rest from L1."""
        ops = np.asarray(ops, dtype=np.int64)
        i = i0 - np.concatenate([[0], np.cumsum(ops != linear_tb.OP_LEFT)[:-1]])
        j = j0 - np.concatenate([[0], np.cumsum(ops != linear_tb.OP_UP)[:-1]])
        sector = (base + i * ld + j)[j > 0] // 32  # column 0 loads nothing
        new = int(np.count_nonzero(np.diff(sector, prepend=-1)))
        old = new * peak["l2_load_clocks"] + (
            len(sector) - new) * peak["l1_load_clocks"]
        clocks = len(sector) * peak["smem_load_clocks"] + (
            peak["l2_load_clocks"] if len(sector) else 0.0)
        return 1e3 * clocks / sm_hz, 1e3 * old / sm_hz, (new, len(sector) - new)

    def fill_bytes(args, out_bytes):
        ta, tb, cost, _, _, mt, _ = args
        return 4 * (ta.numel() + tb.numel() + cost.numel() + 2 * len(mt)) + out_bytes

    arms = {
        "64 x 1024^2": (serving_chunk(rng, DNA, 64, 1024, 1024), {}),
        "64 x 4096^2": (serving_chunk(rng, DNA, 64, 4096, 4096), {}),
        "1024-pair DNA chunk": chunks["dna"],
        "1024-pair BLOSUM62 chunk": chunks["blosum62"],
    }
    arm_cost = {}
    serving_rec = {}  # (arm, traceback) -> e2e, device fill / walk, phases
    for arm, (pairs, kw) in arms.items():
        scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
        cells = sum(len(a) * len(b) for a, b in pairs)
        for with_tb in (False, True):
            tot, fill_ms, walk_ms_b, phase_ms = time_align_pairs(
                pairs, scheme, with_tb
            )
            serving_rec[arm, with_tb] = dict(e2e=tot, fill=fill_ms,
                                             walk=walk_ms_b, phases=phase_ms)
            log(f"phase 3: align_pairs {arm} traceback={with_tb} on {card}: "
                f"{tot:.4f} ms ({len(pairs) / tot * 1e3:.2f} pairs/s, "
                f"{cells / tot / 1e6:.4f} GCUPS); device: fill {fill_ms:.4f} ms"
                f", walk {walk_ms_b:.4f} ms; host phases (ms, phase_seconds): "
                + ", ".join(f"{k} {v:.4f}" for k, v in phase_ms.items())
                + f"; their sum {sum(phase_ms.values()):.4f} ms")
        buckets = bucket_inputs(pairs, scheme)
        ragged = [list(x) for x in zip(*buckets)]  # the main path's one call
        ragged[2:5] = buckets[0][2:5]
        gb = cuda_ms(lambda: fill_batch.batch_final3_ragged(*ragged), 3)
        gf = sum(
            cuda_ms(lambda: fill_cuda.batch_moves(*a, want_moves=False), 3)
            for a in buckets
        )
        gm = sum(cuda_ms(lambda: fill_cuda.batch_moves(*a), 3) for a in buckets)
        gr = cuda_ms(lambda: fill_cuda.batch_moves_ragged(*ragged), 3)
        arm_cost[arm] = (buckets, gb, gf, gm, gr)
        b_ms, b_by = bound(
            cells, "cost", sum(fill_bytes(a, 12 * len(a[5])) for a in buckets)
        )
        m_ms, m_by = bound(cells, "moves", sum(
            fill_bytes(a, 12 * len(a[5]) + a[0].shape[1] * a[1].shape[1] * len(a[5]))
            for a in buckets
        ))
        log(f"phase 3: cost fills of {arm} ({len(buckets)} buckets) on {card}: "
            f"batch_final3_ragged over all of them (align_pairs' one call) "
            f"{gb:.4f} ms ({cells / gb / 1e6:.4f} GCUPS), gotoh_fill final3 a "
            f"launch a bucket {gf:.4f} ms ({cells / gf / 1e6:.4f} GCUPS); "
            f"bound {b_ms:.4f} ms ({b_by})")
        log(f"phase 3: moves fills of {arm} ({len(buckets)} buckets) on "
            f"{card}: batch_moves_ragged over all of them (align_pairs' one "
            f"call) {gr:.4f} ms ({cells / gr / 1e6:.4f} GCUPS), one "
            f"gotoh_fill launch a bucket {gm:.4f} ms ({cells / gm / 1e6:.4f} "
            f"GCUPS); bound {m_ms:.4f} ms ({m_by})")

    # A call's letters on both chunks: tokenize_ragged and render_ragged
    # (device time, the card held while the host enqueues) beside their
    # plain versions on the card and their bounds (bytes: each letter, tape
    # op, descriptor and table entry read once, each token and line letter
    # written once, at the HBM rate); then the host steps they replaced,
    # timed in this call on the same chunk: the numpy route's encode (each
    # bucket's tokens by _encode_bucket, two pinned uploads a bucket) and
    # render (one fetch of the tapes, each reversed behind its left moves,
    # linear_tb.render_many), beside align_pairs' pack and its render,
    # fetch and decode phases (above).
    def packed_times(rec):
        call, walk, order, scheme = (rec[k] for k in ("call", "walk", "order",
                                                      "scheme"))
        ops, count, j_exit = walk
        size = call.letters.element_size()
        tok_bytes = (call.letters.numel() * size + call.table.numel() * 4
                     + call.token_desc.numel() * 8
                     + 4 * int(call.token_desc[:, 3].sum()))
        steps, left = int(count.long().sum()), int(j_exit.long().sum())
        ren_bytes = (steps + size * call.line_cap + 3 * size * (steps + left)
                     + 4 * 2 * len(order) + 8 * 3 * len(order)
                     + call.render_desc.numel() * 8)
        lines = call.lines()
        tok_args = (call.letters, call.table, call.token_desc, call.arena)
        lens = count.long() + j_exit.long()
        starts = torch.cumsum(lens, 0) - lens
        out = dict(
            tokenize_ms=device_ms(lambda: packed.tokenize_ragged(*tok_args), 20),
            tokenize_plain_ms=cuda_ms(lambda: packed.tokenize_plain(*tok_args), 3),
            tokenize_bound_ms=1e3 * tok_bytes / hbm_bytes_s,
            tokenize_bytes=tok_bytes,
            render_ms=device_ms(lambda: packed.render_ragged(
                *walk, call.letters, call.render_desc, lines), 20),
            render_plain_ms=cuda_ms(lambda: packed.render_plain(
                *walk, starts, call.letters, call.render_desc, lines), 3),
            render_bound_ms=1e3 * ren_bytes / hbm_bytes_s,
            render_bytes=ren_bytes,
        )
        keys = {}
        for k, (a, b) in enumerate(order):
            keys.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                            []).append(k)
        enc, ren = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for (mm, nn), idx in keys.items():
                batch_mod._to_device(batch_mod._encode_bucket(
                    scheme.alphabet, [order[i][0] for i in idx], mm), dev)
                batch_mod._to_device(batch_mod._encode_bucket(
                    scheme.alphabet, [order[i][1] for i in idx], nn), dev)
            torch.cuda.synchronize()
            enc.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            tapes, counts, j_exits = batch_mod._to_host(
                [ops.reshape(-1), count, j_exit])
            width = ops.shape[1]
            fwd = [np.concatenate((
                np.full(j_exits[k], linear_tb.OP_LEFT, np.uint8),
                tapes[k * width : k * width + counts[k]][::-1]))
                for k in range(len(order))]
            linear_tb.render_many(fwd, [a for a, _ in order],
                                  [b for _, b in order])
            ren.append(1e3 * (time.perf_counter() - t0))
        out.update(numpy_encode_ms=float(np.median(enc)),
                   numpy_fetch_and_render_ms=float(np.median(ren)))
        return out

    for name in ("dna", "blosum62"):
        packed_rec[name].update(packed_times(packed_rec[name]))
        r = packed_rec[name]
        arm = f"1024-pair {'DNA' if name == 'dna' else 'BLOSUM62'} chunk"
        ph = serving_rec[arm, True]["phases"]
        log(f"phase 3: a call's letters, the {name} chunk on {card} (device "
            f"time): tokenize_ragged {r['tokenize_ms']:.4f} ms (plain on the "
            f"card {r['tokenize_plain_ms']:.4f}, bound {r['tokenize_bound_ms']:.4f}"
            f" ms, {r['tokenize_bytes']} bytes), render_ragged "
            f"{r['render_ms']:.4f} ms with its offsets (plain on the card "
            f"{r['render_plain_ms']:.4f}, bound {r['render_bound_ms']:.4f} ms, "
            f"{r['render_bytes']} bytes); host, this call: the numpy route's "
            f"encode {r['numpy_encode_ms']:.4f} ms against align_pairs' pack "
            f"{ph.get('pack', 0.0):.4f} ms, its fetch + render "
            f"{r['numpy_fetch_and_render_ms']:.4f} ms against align_pairs' "
            f"render + fetch + traceback {ph.get('render', 0.0):.4f} + "
            f"{ph.get('fetch', 0.0):.4f} + {ph.get('traceback', 0.0):.4f} ms")

    # The kernel record's bucket: the DNA chunk's largest bucket, one launch.
    dna_buckets = arm_cost["1024-pair DNA chunk"][0]
    bucket = max(dna_buckets, key=lambda a: len(a[5]))
    bucket_cells = sum(m * n for m, n in zip(bucket[5], bucket[6]))
    batch_ms = device_ms(lambda: fill_batch.batch_final3(*bucket), 5)
    batch_fill_ms = device_ms(
        lambda: fill_cuda.batch_moves(*bucket, want_moves=False), 5
    )
    ta_b, tb_b, cost_b, gid_b, go_b, mt_b, nt_b = bucket

    def plain_bucket():
        for b in range(len(mt_b)):
            fill_rows.row_fill(ta_b[b, : mt_b[b] + 1], tb_b[b, : nt_b[b] + 1],
                               cost_b, gid_b, go_b, want_moves=False)

    plain_batch_ms = cuda_ms(plain_bucket, 1)
    batch_bound, batch_bound_by = bound(
        bucket_cells, "cost", fill_bytes(bucket, 12 * len(mt_b))
    )
    log(f"phase 3: gotoh_batch on one {ta_b.shape[1] - 1} x {tb_b.shape[1] - 1} "
        f"bucket of {len(mt_b)} pairs on {card} (device time): {batch_ms:.4f} "
        f"ms, gotoh_fill final3 {batch_fill_ms:.4f} ms, plain row scan on the card "
        f"{plain_batch_ms:.4f} ms, bound {batch_bound:.4f} ms ({batch_bound_by})")

    # The whole DNA chunk as one launch, padded to its widest bucket (the
    # kernels take each pair's lengths, so the results are the same): how
    # the two kernels scale once a launch holds several warps per SM.
    dna_pairs = chunks["dna"][0]
    whole = to_dev(fill_args(
        resolve_scheme(*("".join(s) for s in zip(*dna_pairs))), dna_pairs
    ))
    one_batch = device_ms(lambda: fill_batch.batch_final3(*whole), 5)
    one_fill = device_ms(
        lambda: fill_cuda.batch_moves(*whole, want_moves=False), 3
    )
    same = torch.equal(
        fill_batch.batch_final3(*whole),
        fill_cuda.batch_moves(*whole, want_moves=False)[0],
    )
    if not same:
        raise SystemExit("phase 3 failed: gotoh_batch != gotoh_fill final3")
    whole_cells = sum(m * n for m, n in zip(whole[5], whole[6]))
    whole_bound, whole_by = bound(whole_cells, "cost",
                                  fill_bytes(whole, 12 * len(whole[5])))
    log(f"phase 3: the DNA chunk as one launch of 1024 pairs padded to "
        f"{whole[0].shape[1] - 1} x {whole[1].shape[1] - 1} on {card} (device "
        f"time): gotoh_batch {one_batch:.4f} ms ({whole_cells / one_batch / 1e6:.4f} "
        f"GCUPS, {whole_cells / (one_batch * 1e-3) / (sms * sm_hz):.4f} cells a "
        f"clock an SM), gotoh_fill final3 {one_fill:.4f} ms "
        f"({whole_cells / one_fill / 1e6:.4f} GCUPS); bound {whole_bound:.4f} ms "
        f"({whole_by}); final3 equal")

    # The main path's call on the DNA chunk (align_pairs' one ragged fill
    # over its 49 buckets), device time and host + device.
    chunk_args = [list(x) for x in zip(*dna_buckets)]
    chunk_args[2:5] = dna_buckets[0][2:5]
    chunk_dev_ms = device_ms(lambda: fill_batch.batch_final3_ragged(*chunk_args), 5)
    chunk_host_ms = arm_cost["1024-pair DNA chunk"][1]
    chunk_bound, chunk_by = bound(
        sum(m * n for a in dna_buckets for m, n in zip(a[5], a[6])), "cost",
        sum(fill_bytes(a, 12 * len(a[5])) for a in dna_buckets),
    )
    before = fill_batch.batch_final3.launches
    fill_batch.batch_final3_ragged(*chunk_args)
    chunk_call_launches = fill_batch.batch_final3.launches - before
    log(f"phase 3: the DNA chunk's {len(dna_buckets)} buckets in one "
        f"batch_final3_ragged call ({chunk_call_launches} gotoh_batch launch) "
        f"on {card}: device {chunk_dev_ms:.4f} ms, host + device "
        f"{chunk_host_ms:.4f} ms; bound {chunk_bound:.4f} ms ({chunk_by})")

    # The crossover: gotoh_batch (a warp a pair) against gotoh_fill final3
    # (a pair over several SMs) at B pairs of n x n, device time; plan()
    # routes by width alone, which holds only if gotoh_batch wins at every
    # B.
    crossover = []
    for nn in (1024, 256):
        for nb in (1, 33, 66, 132, 264, 528, 1024):
            sweep = [(random_seq(rng, DNA, nn), random_seq(rng, DNA, nn))
                     for _ in range(nb)]
            a = to_dev(fill_args(dna_fill, sweep))
            t_batch = device_ms(lambda: fill_batch.batch_final3(*a), 3)
            t_fill = device_ms(
                lambda: fill_cuda.batch_moves(*a, want_moves=False), 3)
            if not torch.equal(fill_batch.batch_final3(*a),
                               fill_cuda.batch_moves(*a, want_moves=False)[0]):
                raise SystemExit(f"phase 3 failed: crossover {nb} x {nn}^2")
            crossover.append(dict(B=nb, n=nn, gotoh_batch_ms=t_batch,
                                  gotoh_fill_ms=t_fill))
            log(f"phase 3: crossover {nb} x {nn}^2 on {card} (device time): "
                f"gotoh_batch {t_batch:.4f} ms, gotoh_fill final3 {t_fill:.4f} "
                f"ms; final3 equal")
    lost = [c for c in crossover if c["gotoh_fill_ms"] < c["gotoh_batch_ms"]]
    log(f"phase 3: crossover: gotoh_fill final3 faster at "
        f"{[(c['B'], c['n']) for c in lost] or 'no shape'} of the sweep")

    # The runner over 4 chunks of 1024 DNA pairs, both modes.  Its one-deep
    # pipeline overlaps a chunk's host work with the next chunk's fills, so
    # the per-chunk rates it logs overstate; the steady rate here is chunks
    # 1-3 over the time between the journal lines of chunks 0 and 3.
    runner_pairs = serving_chunk(rng, DNA, 4096, 819, 1024)
    for with_tb in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            stats_log = io.StringIO()
            runner = BatchRunner(output=Path(tmp) / "out.tsv",
                                 with_traceback=with_tb, log=stats_log)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = runner.run(runner_pairs)
            wall = time.perf_counter() - t0
            stamps = [json.loads(x)["ts"] for x in
                      runner.manifest_path.read_text().splitlines()]
        steady = 3 * 1024 / (stamps[3] - stamps[0])
        phases = [json.loads(x)["phase_seconds"]
                  for x in stats_log.getvalue().splitlines() if '"chunk"' in x]
        log(f"phase 3: runner, 4 chunks of 1024 DNA pairs, traceback="
            f"{with_tb}, on {card}: {len(runner_pairs) / wall:.2f} pairs/s "
            f"over the whole run ({wall:.4f} s), steady (chunks 1-3) "
            f"{steady:.2f} pairs/s; summary {stats.as_dict()}; phase seconds "
            f"per chunk {phases}")

    # The bound of every gotoh_fill mode at the square shapes timed above:
    # tokens in, final3 out, plus the codes (1 byte a cell) or the injected
    # and last rows (12 bytes a column each).
    def square_bound(n, mode, extra):
        return bound(n * n, mode, 8 * (n + 1) + 12 + extra)

    bounds = {
        f"{label} {n}^2": square_bound(n, mode, extra(n))
        for n in (4096, 8000, 10_000, 20_000)
        for label, mode, extra in (
            ("moves", "moves", lambda n: (n + 1) ** 2),
            ("cost-only", "cost", lambda n: 0),
            ("injected last rows", "cost", lambda n: 24 * (n + 1)),
        )
    }
    log(f"phase 3: bounds on {card} (the peaks above; {hbm_bytes_s / 1e12} "
        f"TB/s): " + "; ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                               for k, v in bounds.items()))
    fill_bound, fill_by = bounds[f"moves {fill_size}^2"]
    walk_lat, walk_old, (walk_new, walk_near) = walk_bound(*walk_path)
    walk_bytes = 1e3 * (2 * walk_steps + 24) / hbm_bytes_s
    walk_bound_ms = max(walk_lat, walk_bytes)
    walk_by = "operations" if walk_lat >= walk_bytes else "bytes"
    log(f"phase 3: walk bound on {card}: {walk_steps} dependent steps, "
        f"{walk_new + walk_near} code loads at "
        f"{peak['smem_load_clocks']:.2f} clocks (shared memory) + one L2 "
        f"latency ({peak['l2_load_clocks']:.2f} clocks): {walk_lat:.4f} ms; "
        f"bytes {walk_bytes:.6f} ms; the kernel {walk_ms:.4f} ms. The old "
        f"design's floor, its codes read where they lie ({walk_new} loads "
        f"opening a sector from L2, {walk_near} from L1): {walk_old:.4f} ms")

    # walk_block at the shape of most of its launches: one traceback bucket
    # of the DNA chunk (its largest), walked from each pair's (m, n) as
    # align_pairs walks it.  A thread block walks a pair, so the bound is
    # the longest walk's chain of dependent loads (walk_bound of each pair's
    # own tape, codes at its offset in the bucket), against its bytes.
    ta_w, tb_w, cost_w, gid_w, go_w, mt_w, nt_w = bucket
    bucket_f3, bucket_mv = fill_cuda.batch_moves(*bucket)
    n_w = torch.tensor(nt_w, dtype=torch.int32, device=dev)
    lvl_w = bucket_f3.argmin(-1).to(torch.int32)
    walk_bucket_ms = cuda_ms(
        lambda: linear_tb.walk_block(bucket_mv, mt_w, n_w, lvl_w), 5)
    ops_w, count_w, _, _ = (x.cpu() for x in
                            linear_tb.walk_block(bucket_mv, mt_w, n_w, lvl_w))
    wb_plain = linear_tb.walk_block(bucket_mv.cpu(), mt_w, n_w.cpu(), lvl_w.cpu())
    err = max(abs_err(g, w) for g, w in zip((ops_w, count_w), wb_plain[:2]))
    if err != 0:
        raise SystemExit("phase 3 failed: walk_block != plain on a bucket")
    n1_w, m1_w = bucket_mv.shape[2], bucket_mv.shape[1]
    chains, old_chains = [], []
    for b in range(len(mt_w)):
        # the pair's codes start at b (M+1)(N+1): shift its rows by that
        lat, old, _ = walk_bound(ops_w[b, : int(count_w[b])].numpy(),
                                 mt_w[b] + b * m1_w, nt_w[b], n1_w)
        chains.append(lat)
        old_chains.append(old)
    walk_b_bytes = 1e3 * (int(count_w.sum()) * 2 + 24 * len(mt_w)) / hbm_bytes_s
    walk_b_bound = max(max(chains), walk_b_bytes)
    walk_b_old = max(max(old_chains), walk_b_bytes)
    walk_b_by = "operations" if max(chains) >= walk_b_bytes else "bytes"
    walk_steps_b = int(count_w.max())
    log(f"phase 3: walk_block on one traceback bucket of the DNA chunk "
        f"({len(mt_w)} pairs, {m1_w - 1} x {n1_w - 1}, longest walk "
        f"{walk_steps_b} steps) on {card}: {walk_bucket_ms:.4f} ms; bound "
        f"{walk_b_bound:.4f} ms ({walk_b_by}: the longest walk's loads from "
        f"shared memory + one L2 latency; the old design's floor "
        f"{walk_b_old:.4f} ms); "
        f"= plain walk, max abs err {err}")

    # The traceback chunks' main-path calls: every bucket in one ragged
    # moves fill and one ragged walk, in device time (the host's enqueue
    # hidden), beside the per-bucket launches they replace (a gotoh_fill
    # moves launch and a walk_block launch a bucket) and their bounds: the
    # fill's true cells at the probe's cell rate with codes, against tokens,
    # descriptors, final3 and the packed codes; the walk's longest chain of
    # dependent loads (walk_bound of each pair's own tape at its offset),
    # against its code loads and tape stores.  The plain walk runs over the
    # whole DNA chunk on the host (and is held against the card); the plain
    # fill, the row scan, over the chunk's first bucket (minutes for all of
    # it), held against the chunk's call at those pairs.
    ragged_rec = {}
    for arm in ("1024-pair DNA chunk", "1024-pair BLOSUM62 chunk"):
        buckets = arm_cost[arm][0]
        rargs = [list(x) for x in zip(*buckets)]
        rargs[2:5] = buckets[0][2:5]
        fill_dev = device_ms(lambda: fill_cuda.batch_moves_ragged(*rargs), 5)
        before = fill_batch.batch_moves_warp.launches
        filled = fill_cuda.batch_moves_ragged(*rargs)
        fill_launches = fill_batch.batch_moves_warp.launches - before
        # The same pairs on gotoh_fill's ragged mode (its launch classes of
        # every pair), same descriptors and buffer size: the A/B in one call.
        pair_layout = filled.layout[np.argsort(filled.layout[:, 6])]
        gf_classes = fill_cuda.ragged_classes(pair_layout[:, 2], pair_layout[:, 3], sms)

        def on_gotoh_fill():
            return fill_cuda._launch_ragged(
                [], gf_classes, pair_layout, *rargs[2:5], filled.codes.numel())

        gf_dev = device_ms(on_gotoh_fill, 5)
        gf_filled = on_gotoh_fill()
        if not (torch.equal(gf_filled.final3, filled.final3)
                and torch.equal(gf_filled.codes, filled.codes)):
            raise SystemExit(f"phase 3 failed: {arm}: gotoh_batch_moves != "
                             "gotoh_fill ragged")
        del gf_filled
        walk_dev = device_ms(lambda: linear_tb.walk_ragged(filled), 5)
        r_ops, r_count, r_j = (x.cpu() for x in linear_tb.walk_ragged(filled))
        per_bucket = [fill_cuda.batch_moves(*a) for a in buckets]
        lvl_n = [(f3.argmin(-1).to(torch.int32),
                  torch.tensor(a[6], dtype=torch.int32, device=dev))
                 for (f3, _), a in zip(per_bucket, buckets)]
        fills_dev = device_ms(
            lambda: [fill_cuda.batch_moves(*a) for a in buckets], 3)
        walks_dev = device_ms(lambda: [
            linear_tb.walk_block(mv, a[5], n_t, lvl)
            for (_, mv), a, (lvl, n_t) in zip(per_bucket, buckets, lvl_n)], 3)
        del per_bucket
        lay = filled.layout
        cells = int((lay[:, 2] * lay[:, 3]).sum())
        fill_b, fill_b_by = bound(cells, "moves", sum(
            4 * (a[0].numel() + a[1].numel()) for a in buckets)
            + 4 * buckets[0][2].numel() + filled.codes.numel()
            + (12 + 8 * fill_cuda.DESC_WORDS) * len(lay))
        bounds_w = [walk_bound(r_ops[r, : int(r_count[r])].numpy(), m, n, ld, off)
                    for _, _, m, n, off, ld, r, _ in lay.tolist()]
        chains = [x[0] for x in bounds_w]
        walk_bytes = 1e3 * (2 * int(r_count.sum())
                            + (8 * fill_cuda.DESC_WORDS + 12 + 8) * len(lay)) / hbm_bytes_s
        walk_b = max(max(chains), walk_bytes)
        t_cells = 1e3 * cells / peak["moves_cells_s"]
        t_code_bytes = 1e3 * filled.codes.numel() / hbm_bytes_s
        rec = dict(fill_ms=fill_dev, walk_ms=walk_dev, fill_launches=fill_launches,
                   gotoh_fill_ms=gf_dev, gotoh_fill_launches=len(gf_classes),
                   ops_bound_ms=t_cells, code_bytes_floor_ms=t_code_bytes,
                   per_bucket_fills_ms=fills_dev, per_bucket_walks_ms=walks_dev,
                   buckets=len(buckets), fill_bound_ms=fill_b, fill_bound_by=fill_b_by,
                   walk_bound_ms=walk_b,
                   walk_bound_in_place_ms=max(max(x[1] for x in bounds_w), walk_bytes),
                   walk_bound_by="operations" if max(chains) >= walk_bytes else "bytes",
                   cells=cells, code_bytes=filled.codes.numel(),
                   longest_walk=int(r_count.max()))
        if arm.startswith("1024-pair DNA"):
            host = fill_cuda.RaggedMoves(
                filled.final3.cpu(), filled.codes.cpu(), filled.desc.cpu(), lay)
            t0 = time.perf_counter()
            want = linear_tb.walk_ragged(host)
            rec["walk_plain_ms"] = 1e3 * (time.perf_counter() - t0)
            werr = max(abs_err(g, w) for g, w in zip((r_ops, r_count, r_j), want))
            one = [[t.cpu()] for t in (rargs[0][0], rargs[1][0])]
            t0 = time.perf_counter()
            want = fill_cuda.batch_moves_ragged(
                *one, rargs[2].cpu(), *rargs[3:5], rargs[5][:1], rargs[6][:1])
            rec["fill_plain_ms"] = 1e3 * (time.perf_counter() - t0)
            ferr = max(abs_err(filled.final3[: len(want.final3)], want.final3),
                       abs_err(filled.codes[: want.codes.numel()], want.codes))
            rec["plain_pairs"] = len(want.final3)
            walk_ragged_err = max(walk_ragged_err, werr)
            fill_ragged_err = max(fill_ragged_err, ferr)
            if werr or ferr:
                raise SystemExit("phase 3 failed: the DNA chunk's ragged fill "
                                 "or walk != its plain version")
            log(f"phase 3: plain versions on the host, the DNA chunk: the walk "
                f"over its {len(lay)} pairs {rec['walk_plain_ms']:.4f} ms (max "
                f"abs err {werr}); the row scan over its first bucket "
                f"({rec['plain_pairs']} pairs) {rec['fill_plain_ms']:.4f} ms "
                f"(final3 and codes max abs err {ferr})")
        ragged_rec[arm] = rec
        log(f"phase 3: {arm} traceback on {card} (device time): one ragged "
            f"fill, {fill_launches} gotoh_batch_moves launch, {fill_dev:.4f} ms "
            f"({cells / fill_dev / 1e6:.4f} GCUPS, {filled.codes.numel()} code "
            f"bytes); the same pairs on gotoh_fill's ragged mode "
            f"({len(gf_classes)} launch) {gf_dev:.4f} ms, equal outputs; bound "
            f"{fill_b:.4f} ms ({fill_b_by}: cells at the probe's rate with "
            f"codes {t_cells:.4f} ms, the codes at {hbm_bytes_s / 1e12} TB/s "
            f"{t_code_bytes:.4f} ms); one ragged walk "
            f"{walk_dev:.4f} ms (longest walk {rec['longest_walk']} steps), "
            f"bound {walk_b:.4f} ms ({rec['walk_bound_by']}: the longest "
            f"walk's loads from shared memory + one L2 latency; the old design's "
            f"floor {rec['walk_bound_in_place_ms']:.4f} ms); a launch a bucket, "
            f"{len(buckets)} buckets: fills {fills_dev:.4f} ms, walks "
            f"{walks_dev:.4f} ms")
        del filled

    # gotoh_batch_moves against gotoh_fill's ragged mode at B pairs of
    # n x n, device time, equal outputs: fill_cuda.ragged_routes sends every
    # pair of at most 1024 columns to gotoh_batch_moves whatever B, which
    # holds only if it wins at every B.  Then the mesh path's bucket shard,
    # 8 pairs of 992 x 1024 (gotoh_fill's batch_moves there), on both.
    moves_sweep = []

    def both_routes(a):
        """(gotoh_batch_moves ms, gotoh_fill ragged ms) of one bucket's
        ragged moves fill, outputs held equal."""
        rargs = ([a[0]], [a[1]], *a[2:5], [a[5]], [a[6]])
        t_new = device_ms(lambda: fill_cuda.batch_moves_ragged(*rargs), 3)
        filled = fill_cuda.batch_moves_ragged(*rargs)
        lay = filled.layout[np.argsort(filled.layout[:, 6])]
        classes = fill_cuda.ragged_classes(lay[:, 2], lay[:, 3], sms)

        def run_gf():
            return fill_cuda._launch_ragged([], classes, lay, *a[2:5],
                                            filled.codes.numel())

        t_gf = device_ms(run_gf, 3)
        gf = run_gf()
        if not (torch.equal(gf.final3, filled.final3)
                and torch.equal(gf.codes, filled.codes)):
            raise SystemExit(f"phase 3 failed: gotoh_batch_moves != gotoh_fill "
                             f"ragged at {len(a[5])} pairs")
        return t_new, t_gf

    for nn in (1024, 256):
        for nb in (1, 8, 33, 132, 1024):
            a = to_dev(fill_args(dna_fill, [
                (random_seq(rng, DNA, nn), random_seq(rng, DNA, nn))
                for _ in range(nb)]))
            t_new, t_gf = both_routes(a)
            moves_sweep.append(dict(B=nb, n=nn, gotoh_batch_moves_ms=t_new,
                                    gotoh_fill_ragged_ms=t_gf))
            log(f"phase 3: moves crossover {nb} x {nn}^2 on {card} (device "
                f"time): gotoh_batch_moves {t_new:.4f} ms, gotoh_fill ragged "
                f"{t_gf:.4f} ms; outputs equal")
    lost = [c for c in moves_sweep
            if c["gotoh_fill_ragged_ms"] < c["gotoh_batch_moves_ms"]]
    log(f"phase 3: moves crossover: gotoh_fill ragged faster at "
        f"{[(c['B'], c['n']) for c in lost] or 'no shape'} of the sweep")
    a = to_dev(fill_args(dna_fill, [
        (random_seq(rng, DNA, 992), random_seq(rng, DNA, 1024)) for _ in range(8)]))
    shard_new, shard_gf = both_routes(a)
    shard_fill = device_ms(lambda: fill_cuda.batch_moves(*a), 3)
    log(f"phase 3: the mesh path's bucket shard, 8 x 992 x 1024, on {card} "
        f"(device time): gotoh_batch_moves {shard_new:.4f} ms, gotoh_fill "
        f"ragged {shard_gf:.4f} ms, gotoh_fill batch_moves (the mesh path's "
        f"launch) {shard_fill:.4f} ms")

    # -- phase 3, the parallel layer ---------------------------------------
    # The strip mode at its main-path shape: the first block of the
    # 50 000^2 world-of-one fill (RB 256 x W 50 000, at the matrix edge),
    # beside its plain version on the card and its bound.
    _, big_aligner, big_enc = world1_cost["50000^2 DNA"]
    ta, tb, cost, gid, go = big_enc
    rb, width = seqpar.DEFAULT_BLOCK_ROWS, tb.shape[0] - 1
    row0_g, col0_g = default_boundary(ta, tb, cost, gid, go)
    blk = (ta[None, : rb + 1].contiguous(), tb[None], cost, gid, go,
           row0_g[None].contiguous(), col0_g[None, :, : rb + 1].contiguous())
    strip_ms = cuda_ms(lambda: fill_cuda.strip_fill_block(*blk, [rb]), 5)
    plain_strip_ms = cuda_ms(
        lambda: fill_rows.row_fill(
            blk[0][0], tb, cost, gid, go, rb, width, row0=row0_g,
            col0=blk[6][0], want_moves=False, col0_full=True, want_edge=True,
            want_fin_row=True,
        ),
        1,
    )
    got = fill_cuda.strip_fill_block(*blk, [rb])
    want = fill_cuda.strip_fill_block(
        *(x.cpu() if isinstance(x, torch.Tensor) else x for x in blk), [rb]
    )
    err = max(abs_err(g, w) for g, w in zip(got, want))
    strip_err = max(strip_err, err)
    if err != 0:
        raise SystemExit("phase 3 failed: strip mode != plain at 256 x 50000")
    strip_cells = rb * width
    strip_bytes = 4 * (  # tokens, table, row0 and col0 in; fin, edge out
        (rb + 1) + (width + 1) + cost.numel() + 2 + 6 * (width + 1)
        + 6 * (rb + 1) + 3
    )
    strip_bound, strip_by = bound(strip_cells, "cost", strip_bytes)
    log(f"phase 3: strip mode, one {rb} x {width} block on {card}: "
        f"{strip_ms:.4f} ms ({strip_cells / strip_ms / 1e6:.4f} GCUPS), plain "
        f"row scan (col0_full, want_edge, want_fin_row) on the card "
        f"{plain_strip_ms:.4f} ms, bound {strip_bound:.4f} ms ({strip_by}); "
        f"max abs err {err}")

    # The world of one at 50 000^2 beside cost() (the split) and the direct
    # cost-only fill, host clock around synchronised calls.
    s1, s2 = big_pair
    w1_ms = 1e3 * median_s(lambda: seqpar.sharded_pair_cost(world1, *big_enc), 1)
    split_ms = 1e3 * median_s(lambda: big_aligner.cost(s1, s2), 3)
    direct_ms = 1e3 * median_s(
        lambda: fill_cuda.batch_moves(ta[None], tb[None], cost, gid, go,
                                      [len(s1)], [len(s2)], want_moves=False),
        1,
    )
    big_cells = len(s1) * len(s2)
    log(f"phase 3: 50000^2 DNA cost on {card}: sharded_pair_cost (NCCL world "
        f"of one, {-(-len(s1) // rb)} strip blocks) {w1_ms:.4f} ms "
        f"({big_cells / w1_ms / 1e6:.4f} GCUPS); cost() (the split) "
        f"{split_ms:.4f} ms; direct cost-only fill {direct_ms:.4f} ms")
    shift_all = [x for shifts in gloo_exchange for x in shifts]
    log(f"phase 3: gloo exchange (pinned host staging, {ranks} ranks sharing "
        f"the card, 50000^2 DNA; host clock, so it holds each rank's wait for "
        f"its left neighbour's block): {len(gloo_exchange[0])} super-steps a "
        f"rank, median {1e3 * float(np.median(shift_all)):.4f} ms, mean "
        f"{1e3 * float(np.mean(shift_all)):.4f} ms a step; jobs' seconds by "
        f"rank {[[round(a['seconds'], 3) for a in r] for r in gloo]}")
    for with_tb in (False, True):
        dna_scheme = resolve_scheme(*dna_seqs)
        plain_pairs_ms = 1e3 * median_s(lambda: align_pairs(
            dna_chunk, scheme=dna_scheme, with_traceback=with_tb))
        mesh_pairs_ms = 1e3 * median_s(lambda: align_pairs(
            dna_chunk, scheme=dna_scheme, with_traceback=with_tb, mesh=world1))
        log(f"phase 3: align_pairs DNA chunk traceback={with_tb} on {card}: "
            f"unsharded {plain_pairs_ms:.4f} ms, mesh=NCCL world of one "
            f"{mesh_pairs_ms:.4f} ms")
    dist.destroy_process_group()


    # -- phase 3, the wave kernel and the dual-set fill --------------------
    # The wave kernel at the two main-path shapes beside the row split
    # (fill_split: one 2-pair last-rows launch + join), in turns (wave,
    # split, split, wave), then cost() end to end and the direct cost-only
    # fill: does the anti-diagonal split beat the row split on this card?
    # Its bound: the cells both problems reach at the probe's cost-only
    # cell rate (the function needs no more than the probe's cost-only
    # cell; as in every fill bound, the substitution cost is free), against
    # tokens read once and four captured waves written once.  Beside it the
    # parts of the critical path: the longest chain of dependent tiles (b +
    # c + 1 at the last ticketed tile anti-diagonal), and a tile's time,
    # measured on a pair one tile column wide (50 000 x 32 W), whose tiles
    # run one after another; their product is a model, logged as one.
    def wave_cells(m, n, tend):
        """Cells that waves 1..tend reach: rows max(0, t-n)..min(t, m)."""
        return sum(max(0, min(t, m) - max(0, t - n) + 1)
                   for t in range(1, tend + 1))

    def chain_tiles(m, n):
        pl = fill_wave.plan(m, n)
        order = fill_wave.tile_order(m, n, pl.width, pl.height)
        return int(((order[:, 0] >> 1) + order[:, 1]).max()) + 1 if len(order) else 0

    enc50 = wave_main["50000^2 DNA"][0]
    col_n = fill_wave.WARP * wave_plan.width
    enc_col = (enc50[0], enc50[1][: col_n + 1].contiguous(), *enc50[2:8], col_n)
    col_ms = cuda_ms(lambda: fill_wave.wave_frontiers(*enc_col), 3)
    col_chain = chain_tiles(enc50[7], col_n)
    tile_ms = col_ms / col_chain
    log(f"phase 3: wave_split one tile column, {enc50[7]} x {col_n} on {card}: "
        f"{col_ms:.4f} ms over a chain of {col_chain} tiles of "
        f"{wave_plan.height} x {col_n}: {1e3 * tile_ms:.4f} us a tile")

    wave_rec = {}
    for label, (enc, aligner, (s1, s2)) in wave_main.items():
        ta, tb, *prm_go, m, n = enc
        big = m > 10_000
        reps = 3 if big else 5
        cost_args = (ta, tb, aligner.cost_mat, aligner.gap_id, aligner.gap_open)
        turns = []
        for arm in ("wave", "split", "split", "wave"):
            fn = ((lambda: fill_wave.wave_frontiers(*enc)) if arm == "wave"
                  else (lambda: fill_split.split_fill_cost(*cost_args)))
            turns.append(cuda_ms(fn, reps))
        w_ms = (turns[0] + turns[3]) / 2
        split_k_ms = (turns[1] + turns[2]) / 2
        direct_k_ms = cuda_ms(
            lambda: fill_cuda.batch_moves(ta[None], tb[None], *cost_args[2:],
                                          [m], [n], want_moves=False),
            1 if big else 3,
        )
        wave_e2e = 1e3 * median_s(
            lambda: int(fill_wave.wave_split_fill_cost(*enc)), 1 if big else 3
        )
        cost_e2e = 1e3 * median_s(lambda: aligner.cost(s1, s2), 1 if big else 3)
        (_, t_split), (_, tmax) = fill_wave.capture_waves(m, n)
        cells = wave_cells(m, n, t_split) + wave_cells(m, n, tmax)
        w_bound, w_by = bound(
            cells, "cost", 4 * (ta.numel() + tb.numel()) + 4 * 12 * ta.numel()
        )
        chain = chain_tiles(m, n)
        wave_rec[label] = dict(ms=w_ms, bound_ms=w_bound, bound_by=w_by,
                               chain_tiles=chain, cells=cells,
                               split_ms=split_k_ms, direct_ms=direct_k_ms,
                               e2e_ms=wave_e2e, cost_e2e_ms=cost_e2e,
                               turns_ms=turns)
        log(f"phase 3: wave_split {label} on {card}: kernel {w_ms:.4f} ms "
            f"({cells / w_ms / 1e6:.4f} Gcells/s over the {cells} cells both "
            f"problems reach; turns wave / split / split / wave "
            f"{' / '.join(f'{t:.4f}' for t in turns)} ms), "
            f"wave_split_fill_cost end to end {wave_e2e:.4f} ms; row split "
            f"(fill_split) {split_k_ms:.4f} ms, cost() end to end "
            f"{cost_e2e:.4f} ms; direct cost-only fill {direct_k_ms:.4f} ms; "
            f"bound {w_bound:.4f} ms ({w_by}); critical path model: a chain "
            f"of {chain} tiles x {1e3 * tile_ms:.4f} us a tile (the one-tile-"
            f"column pair) = {chain * tile_ms:.4f} ms")
    # Its plain version on the card at 10 000^2, one run, held against the
    # kernel there.
    enc10 = wave_main["10000^2 DNA"][0]
    got = fill_wave.wave_frontiers(*enc10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fill_wave._plain(*enc10)
    torch.cuda.synchronize()
    wave_plain_ms = 1e3 * (time.perf_counter() - t0)
    err = abs_err(got, want.cpu())
    wave_err = max(wave_err, err)
    if err != 0:
        raise SystemExit("phase 3 failed: wave_split != plain at 10000^2")
    log(f"phase 3: wave_split plain version (the wave recurrence in torch) on "
        f"the card, 10000^2, one run: {wave_plain_ms:.4f} ms; four captured "
        f"waves max abs err {err}")
    # And once at the 50 000^2 main-path shape: phase 2 holds the kernel
    # there only as a cost against cost().
    got = fill_wave.wave_frontiers(*enc50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fill_wave._plain(*enc50)
    torch.cuda.synchronize()
    wave_plain50_ms = 1e3 * (time.perf_counter() - t0)
    err = abs_err(got, want.cpu())
    wave_err = max(wave_err, err)
    if err != 0:
        raise SystemExit("phase 3 failed: wave_split != plain at 50000^2")
    log(f"phase 3: wave_split plain version on the card, 50000^2, one run: "
        f"{wave_plain50_ms:.4f} ms; four captured waves max abs err {err}")

    # The dual launch beside two single-set launches, in turns (dual,
    # singles, singles, dual): 64 x 4096^2 a set, and the DNA chunk's two
    # widest buckets (phase 2's sets).  Its bound and its plain version on
    # the card (the row scan pair by pair) at the chunk's sets.
    sets64 = serving_chunk(rng, DNA, 128, 4096, 4096)
    ta64, tb64, cost64, gid64, go64, mt64, nt64 = to_dev(fill_args(
        resolve_scheme(*("".join(s) for s in zip(*sets64))), sets64
    ))
    dual64 = (ta64.reshape(2, 64, -1), tb64.reshape(2, 64, -1), cost64, gid64,
              go64, np.reshape(mt64, (2, 64)), np.reshape(nt64, (2, 64)))

    def two_singles(a):
        for k in range(2):
            fill_batch.batch_final3(a[0][k], a[1][k], *a[2:5], a[5][k], a[6][k])

    dual_rec = {}
    for label, a in (("64 x 4096^2 a set", dual64),
                     ("the DNA chunk's two widest buckets", dual_args)):
        if not torch.equal(
            fill_batch.batch_final3_dual(*a),
            torch.stack([fill_batch.batch_final3(a[0][k], a[1][k], *a[2:5],
                                                 a[5][k], a[6][k])
                         for k in range(2)]),
        ):
            raise SystemExit(f"phase 3 failed: dual != two single sets, {label}")
        d1 = cuda_ms(lambda: fill_batch.batch_final3_dual(*a), 5)
        s1_ms = cuda_ms(lambda: two_singles(a), 5)
        s2_ms = cuda_ms(lambda: two_singles(a), 5)
        d2 = cuda_ms(lambda: fill_batch.batch_final3_dual(*a), 5)
        cells = sum(int(m) * int(n) for mk, nk in zip(a[5], a[6])
                    for m, n in zip(mk, nk))
        d_bound, d_by = bound(
            cells, "cost",
            4 * (a[0].numel() + a[1].numel() + a[2].numel()) + 8 * 2 * len(a[5][0])
            + 12 * 2 * len(a[5][0]),
        )
        dual_rec[label] = dict(ms=(d1 + d2) / 2, single_ms=(s1_ms + s2_ms) / 2,
                               bound_ms=d_bound, bound_by=d_by, cells=cells)
        log(f"phase 3: batch_final3_dual, {label} ({a[0].shape[1]} pairs a set, "
            f"{a[0].shape[2] - 1} x {a[1].shape[2] - 1}) on {card}: one dual "
            f"launch {d1:.4f} / {d2:.4f} ms, two single-set launches "
            f"{s1_ms:.4f} / {s2_ms:.4f} ms ({cells / ((d1 + d2) / 2) / 1e6:.4f} "
            f"against {cells / ((s1_ms + s2_ms) / 2) / 1e6:.4f} GCUPS); bound "
            f"{d_bound:.4f} ms ({d_by})")
    ta2, tb2, cost2, gid2, go2, m2, n2 = dual_args

    def plain_dual():
        return torch.stack([
            torch.stack([
                fill_rows.row_fill(ta2[k, b, : m2[k][b] + 1],
                                   tb2[k, b, : n2[k][b] + 1], cost2, gid2, go2,
                                   want_moves=False).final3
                for b in range(len(m2[k]))
            ])
            for k in range(2)
        ])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_dual()
    torch.cuda.synchronize()
    dual_plain_ms = 1e3 * (time.perf_counter() - t0)
    err = abs_err(dual_final3, want.cpu())
    dual_err = max(dual_err, err)
    if err != 0:
        raise SystemExit("phase 3 failed: batch_final3_dual != plain on the DNA "
                         "chunk's two widest buckets")
    log(f"phase 3: batch_final3_dual plain version (the row scan pair by pair) "
        f"on the card, the DNA chunk's two widest buckets, one run: "
        f"{dual_plain_ms:.4f} ms; phase 2's (2, {len(m2[0])}, 3) final3 max abs "
        f"err {err}")

    # gotoh_fill at each class of phase 2's census (mode, one pair or a
    # batch, rows and columns by size): the class's most launched (B, M, N)
    # on seeded DNA at full lengths (a bucket's pairs are its full width
    # here), its bound, and launches x (time - bound) for the class.
    def size_class(x):
        return next((f"<={k}" for k in (1024, 4096, 10_000, 20_000) if x <= k),
                    ">20000")

    classes = {}
    for (mode, nb, mm, nn), k in census.items():
        key = (mode, "B=1" if nb == 1 else "B>1", f"M{size_class(mm)}",
               f"N{size_class(nn)}")
        cls = classes.setdefault(key, {"launches": 0, "shapes": collections.Counter()})
        cls["launches"] += k
        cls["shapes"][(nb, mm, nn)] += k

    def census_call(mode, nb, mm, nn):
        pairs = [(random_seq(rng, DNA, mm), random_seq(rng, DNA, nn))
                 for _ in range(nb)]
        ta, tb, cost, gid, go, mt, nt = to_dev(fill_args(dna_fill, pairs))
        if mode == "strip" or mode.endswith("injected"):
            rows, cols = zip(*(default_boundary(ta[b], tb[b], cost, gid, go)
                               for b in range(nb)))
            row0 = torch.stack(rows).contiguous()
            col0 = torch.stack(cols).contiguous()
        if mode == "strip":
            return lambda: fill_cuda.strip_fill_block(ta, tb, cost, gid, go,
                                                      row0, col0, mt)
        inj = {}
        if mode.endswith("injected"):
            inj = dict(row0=row0, col0y_top=torch.full(
                (nb,), go, dtype=torch.int32, device=dev))
        if mode.startswith("codes"):
            return lambda: fill_cuda.batch_moves(ta, tb, cost, gid, go, mt, nt,
                                                 **inj)
        if mode.startswith("last rows"):
            return lambda: fill_cuda.batch_last_rows(ta, tb, cost, gid, go, mt,
                                                     nt, **inj)
        return lambda: fill_cuda.batch_moves(ta, tb, cost, gid, go, mt, nt,
                                             want_moves=False, **inj)

    census_rows = []
    for key in sorted(classes):
        cls = classes[key]
        (nb, mm, nn), _ = max(cls["shapes"].items(),
                              key=lambda kv: (kv[1], kv[0][0] * kv[0][1] * kv[0][2]))
        mode = key[0]
        cells = nb * mm * nn
        with gotoh_fill_only(fill_tile):  # the class is gotoh_fill's
            t_ms = cuda_ms(census_call(mode, nb, mm, nn), 1 if cells > 2e8 else 3)
        b_ms, _ = bound(cells, "moves" if mode.startswith("codes") else "cost",
                        8 * nb * (mm + nn + 2))
        loss = cls["launches"] * (t_ms - b_ms)
        census_rows.append(dict(
            mode=mode, cls=list(key[1:]), launches=cls["launches"],
            shape=[nb, mm, nn], ms=t_ms, bound_ms=b_ms, loss_ms=loss,
            shapes=len(cls["shapes"]),
        ))
        log(f"phase 3: gotoh_fill census {mode}, {' '.join(key[1:])} on {card}: "
            f"{cls['launches']} launches over {len(cls['shapes'])} shapes; at "
            f"the most launched, B x M x N = {nb} x {mm} x {nn}: {t_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms; launches x (time - bound) {loss:.4f} ms")

    log("earlier times, NOT measured in this run: the last chip_smoke.py run "
        "before gotoh_fill's redesign (one block a pair), on an NVIDIA H100 "
        "80GB HBM3 at 700.00 W, gave the 8000^2 moves fill 73.3129 ms and the "
        "256 x 50000 strip block 17.1011 ms")
    dna_rr = ragged_rec["1024-pair DNA chunk"]
    blosum_rr = ragged_rec["1024-pair BLOSUM62 chunk"]
    # gotoh_tile's critical-path bounds (tiles on the path x a tile's time,
    # measured above) at the shapes of the prediction table.
    tile_paths = {
        "8000^2 codes": path_model_ms(
            1, 8000, 8000, tuple(tile_fill[8000]["shape"]), True),
        "4096^2 codes": path_model_ms(
            1, 4096, 4096, tuple(tile_fill[4096]["shape"]), True),
        **{f"checkpoint pass {k}^2": path_model_ms(
            1, k, k, tuple(v["checkpoint_shape"]), False)
           for k, v in blocked_rec.items()},
        **{f"split {k}^2": path_model_ms(
            2, k - k // 2, k, tuple(v["shape"]), False)
           for k, v in split_rec.items()},
        **{f"replay {blocked_rec[20_000]['replay_shape'][0]} x 20000 H={h} "
           f"W={w}": path_model_ms(1, *blocked_rec[20_000]["replay_shape"],
                                   (h, w), True)
           for h, w in fill_tile.SHAPES},
    }
    log(f"phase 3: gotoh_tile critical-path bounds on {card} (tiles on the "
        f"path, ms): " + "; ".join(f"{k} {t} tiles {v:.4f}"
                                   for k, (t, v) in tile_paths.items()))
    log(json.dumps({"kernels": [
        {
            "name": "gotoh_fill",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_fill.cu",
            "replaces": "globalign_tpu/ops/fill_lanes.py:201",
            "also_replaces": [
                "globalign_tpu/ops/fill_pallas.py:496",
                "globalign_tpu/ops/fill_pallas.py:153",
                "globalign_tpu/ops/fill_pallas.py:735",
            ],
            "launches": main_launches["batch_moves"]
            + main_launches["batch_last_rows"],
            "launches_by_wrapper": {
                k: main_launches[k] for k in ("batch_moves", "batch_last_rows")
            },
            "max_abs_err": max_abs_err,
            "shape": f"moves fill, {fill_size}^2 DNA",
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": fill_bound,
            "bound_by": fill_by,
            "library_ms": None,
            "last_rows_ms": last_ms,
            "plain_last_rows_ms": plain_last_ms,
            "census": [r for r in census_rows if r["mode"] != "strip"],
            "cost_only_ms": cost_only_ms,
            "checkpoint_pass_20000_ms": blocked_dev[20_000][0],
            "replay_fills_20000_ms": blocked_dev[20_000][1],
            "dna_chunk_moves_fills_ms": arm_cost["1024-pair DNA chunk"][3],
            "dna_chunk_final3_fills_ms": arm_cost["1024-pair DNA chunk"][2],
            "ptxas": fill_regs,
        },
        {
            "name": "walk_block",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/walk_block.cu",
            "replaces": "globalign_tpu/ops/linear_tb.py:74",
            "launches": main_launches["walk_block"],
            "max_abs_err": walk_err,
            "shape": f"one 10000^2 matrix, {walk_steps} steps",
            "ms": walk_ms,
            "plain_ms": plain_walk_ms,
            "bound_ms": walk_bound_ms,
            "bound_by": walk_by,
            "bound_note": "latency: a chain of dependent code loads, each "
                          "from shared memory, plus one L2 latency",
            "bound_in_place_ms": max(walk_old, walk_bytes),
            "library_ms": None,
            "bucket_shape": f"one traceback bucket of the 1024-pair DNA chunk, "
                            f"{len(mt_w)} pairs of {m1_w - 1} x {n1_w - 1}",
            "bucket_ms": walk_bucket_ms,
            "bucket_bound_ms": walk_b_bound,
            "bucket_bound_by": walk_b_by,
            "bucket_bound_in_place_ms": walk_b_old,
            "align_ms": align_split,
            "ptxas": walk_regs,
        },
        {
            "name": "gotoh_batch",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_batch.cu",
            "replaces": "globalign_tpu/ops/fill_pallas.py:1321",
            "also_replaces": ["globalign_tpu/ops/fill_pallas.py:458"],
            "launches": main_launches["batch_final3"],
            "max_abs_err": batch_err,
            "shape": f"the 1024-pair DNA chunk's {len(dna_buckets)} buckets in "
                     f"one batch_final3_ragged call ({chunk_call_launches} "
                     "launch), device time",
            "ms": chunk_dev_ms,
            "plain_ms": plain_batch_ms,
            "plain_shape": f"the chunk's largest bucket alone, {len(mt_b)} "
                           f"pairs of {ta_b.shape[1] - 1} x {tb_b.shape[1] - 1}",
            "bound_ms": chunk_bound,
            "bound_by": chunk_by,
            "library_ms": None,
            "host_and_device_ms": chunk_host_ms,
            "chunk_gotoh_fill_final3_ms": arm_cost["1024-pair DNA chunk"][2],
            "bucket_ms": batch_ms,
            "bucket_gotoh_fill_final3_ms": batch_fill_ms,
            "bucket_bound_ms": batch_bound,
            "one_launch_padded_ms": one_batch,
            "one_launch_padded_gotoh_fill_ms": one_fill,
            "one_launch_padded_bound_ms": whole_bound,
            "crossover": crossover,
            "ptxas": batch_regs,
        },
        {
            "name": "gotoh_fill_strip",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_fill.cu",
            "replaces": "globalign_tpu/ops/fill_pallas.py:1811",
            "launches": main_launches["strip_fill_block"],
            "max_abs_err": strip_err,
            "shape": f"one {rb} x {width} strip block, DNA (the first "
                     "block of the 50000^2 world-of-one fill)",
            "ms": strip_ms,
            "plain_ms": plain_strip_ms,
            "bound_ms": strip_bound,
            "bound_by": strip_by,
            "library_ms": None,
            "census": [r for r in census_rows if r["mode"] == "strip"],
        },
        {
            "name": "wave_split",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/wave_split.cu",
            "replaces": "globalign_tpu/ops/fill_pallas.py:1510",
            "launches": main_launches["wave_frontiers"],
            "max_abs_err": wave_err,
            "shape": "10000^2 DNA, the bench's wave arm (both problems)",
            "ms": wave_rec["10000^2 DNA"]["ms"],
            "plain_ms": wave_plain_ms,
            "bound_ms": wave_rec["10000^2 DNA"]["bound_ms"],
            "bound_by": wave_rec["10000^2 DNA"]["bound_by"],
            "library_ms": None,
            "tile_us": 1e3 * tile_ms,
            "chain_tiles": wave_rec["10000^2 DNA"]["chain_tiles"],
            "ptxas": wave_regs,
            "row_split_ms": wave_rec["10000^2 DNA"]["split_ms"],
            "ms_50000": wave_rec["50000^2 DNA"]["ms"],
            "bound_ms_50000": wave_rec["50000^2 DNA"]["bound_ms"],
            "chain_tiles_50000": wave_rec["50000^2 DNA"]["chain_tiles"],
            "row_split_ms_50000": wave_rec["50000^2 DNA"]["split_ms"],
            "plain_ms_50000": wave_plain50_ms,
        },
        {
            "name": "gotoh_batch_dual",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_batch.cu",
            "replaces": "globalign_tpu/ops/fill_lanes.py:201",
            "replaces_note": "_make_lane_kernel(npar=2), entries "
                             "fill_lanes.py:1869 and :1902",
            "launches": dual_main_launches,
            "counted_in": "gotoh_batch",
            "counted_note": "the dual call launches gotoh_batch, so its "
                            "launches are already in gotoh_batch's count",
            "max_abs_err": dual_err,
            "shape": f"2 sets of {len(m2[0])} DNA pairs, {ta2.shape[2] - 1} x "
                     f"{tb2.shape[2] - 1} (the 1024-pair chunk's two widest "
                     "buckets)",
            "ms": dual_rec["the DNA chunk's two widest buckets"]["ms"],
            "plain_ms": dual_plain_ms,
            "bound_ms": dual_rec["the DNA chunk's two widest buckets"]["bound_ms"],
            "bound_by": dual_rec["the DNA chunk's two widest buckets"]["bound_by"],
            "library_ms": None,
            "two_single_ms": dual_rec["the DNA chunk's two widest buckets"][
                "single_ms"],
            "ms_64x4096": dual_rec["64 x 4096^2 a set"]["ms"],
            "two_single_ms_64x4096": dual_rec["64 x 4096^2 a set"]["single_ms"],
        },
        {
            "name": "gotoh_batch_moves",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_batch_moves.cu",
            "replaces": "globalign_tpu/ops/fill_lanes.py:1667",
            "also_replaces": ["globalign_tpu/ops/fill_pallas.py:948"],
            "replaces_note": "moves mode over a call's traceback buckets of at "
                             "most 1024 columns: lanes_batch_moves :1978 / "
                             "lanes_general_moves :1791 as "
                             "globalign_tpu/batch.py:_lanes_walk_fills queues "
                             "them; _make_stacked_kernel(want_moves=True)",
            "launches": main_launches["batch_moves_warp"],
            "max_abs_err": max(warp_err, fill_ragged_err),
            "shape": f"the 1024-pair DNA chunk's {dna_rr['buckets']} buckets in "
                     f"one batch_moves_ragged call ({dna_rr['fill_launches']} "
                     "launch), device time",
            "ms": dna_rr["fill_ms"],
            "plain_ms": dna_rr["fill_plain_ms"],
            "plain_shape": f"the row scan on the host over the chunk's first "
                           f"bucket, {dna_rr['plain_pairs']} pairs",
            "bound_ms": dna_rr["fill_bound_ms"],
            "bound_by": dna_rr["fill_bound_by"],
            "ops_bound_ms": dna_rr["ops_bound_ms"],
            "code_bytes_floor_ms": dna_rr["code_bytes_floor_ms"],
            "library_ms": None,
            "gotoh_fill_ragged_ms": dna_rr["gotoh_fill_ms"],
            "blosum62_chunk_ms": blosum_rr["fill_ms"],
            "blosum62_chunk_gotoh_fill_ragged_ms": blosum_rr["gotoh_fill_ms"],
            "blosum62_chunk_bound_ms": blosum_rr["fill_bound_ms"],
            "crossover": moves_sweep,
            "mesh_shard_8x992x1024_ms": shard_new,
            "mesh_shard_gotoh_fill_ragged_ms": shard_gf,
            "mesh_shard_gotoh_fill_batch_moves_ms": shard_fill,
            "ptxas": moves_regs,
        },
        {
            "name": "gotoh_fill_ragged",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_fill.cu",
            "replaces": "globalign_tpu/ops/fill_lanes.py:1667",
            "replaces_note": "moves mode over a call's traceback pairs past "
                             "1024 columns: lanes_batch_moves :1978 / "
                             "lanes_general_moves :1791 as "
                             "globalign_tpu/batch.py:_lanes_walk_fills queues "
                             "them; fill_pallas.py:948 (_pallas_moves)",
            "launches": main_launches["batch_moves_ragged"],
            "max_abs_err": fill_ragged_err,
            "shape": f"the 1024-pair DNA chunk's pairs on gotoh_fill's ragged "
                     f"mode ({dna_rr['gotoh_fill_launches']} launch), device "
                     "time; on the main path it takes the pairs past 1024 "
                     "columns",
            "ms": dna_rr["gotoh_fill_ms"],
            "plain_ms": dna_rr["fill_plain_ms"],
            "plain_shape": f"the row scan on the host over the chunk's first "
                           f"bucket, {dna_rr['plain_pairs']} pairs",
            "bound_ms": dna_rr["fill_bound_ms"],
            "bound_by": dna_rr["fill_bound_by"],
            "library_ms": None,
            "per_bucket_launches_ms": dna_rr["per_bucket_fills_ms"],
            "blosum62_chunk_ms": blosum_rr["gotoh_fill_ms"],
            "blosum62_chunk_bound_ms": blosum_rr["fill_bound_ms"],
            "blosum62_per_bucket_launches_ms": blosum_rr["per_bucket_fills_ms"],
        },
        {
            "name": "gotoh_tile",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_tile.cu",
            "replaces": "globalign_tpu/ops/fill_lanes.py:201",
            "also_replaces": [
                "globalign_tpu/ops/fill_pallas.py:496",
                "globalign_tpu/ops/fill_pallas.py:153",
                "globalign_tpu/ops/fill_pallas.py:735",
            ],
            "replaces_note": "the single-pair launches: align's fill, the "
                             "blocked traceback's checkpoint pass (one launch "
                             "for every block) and replays, cost()'s 2-pair "
                             "split, where fill_tile.route sends them",
            "launches": main_launches["gotoh_tile"],
            "max_abs_err": tile_err,
            "shape": "moves fill, 8000^2 DNA, one pair",
            "ms": tile_fill[8000]["gotoh_tile_ms"],
            "gotoh_fill_ms": tile_fill[8000]["gotoh_fill_ms"],
            "plain_ms": plain_ms,
            "bound_ms": fill_bound,
            "bound_by": fill_by,
            "critical_path_bound_ms": tile_paths["8000^2 codes"][1],
            "critical_path_tiles": tile_paths["8000^2 codes"][0],
            "library_ms": None,
            "fills": tile_fill,
            "align_ms": {k: v for k, v in align_split.items()},
            "blocked": blocked_rec,
            "split": split_rec,
            "critical_paths": {k: {"tiles": t, "ms": v}
                               for k, (t, v) in tile_paths.items()},
            "tile_us": tile_us,
            "sweep": tile_sweep,
            "wide_sweep": wide_rows,
            "route": {"max_batch": fill_tile.ROUTE_MAX_BATCH,
                      "min_side_codes": fill_tile.ROUTE_MIN_SIDE,
                      "min_side_cost_only": fill_tile.ROUTE_MIN_SIDE_COST,
                      "max_aspect": fill_tile.ROUTE_MAX_ASPECT},
            "ptxas": tile_regs,
        },
        {
            "name": "walk_block_ragged",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/walk_block.cu",
            "replaces": "globalign_tpu/ops/linear_tb.py:268",
            "replaces_note": "lanes_mega_walk, the walk of a call's traceback "
                             "buckets in one device program "
                             "(globalign_tpu/batch.py:_mega_walk_flush)",
            "launches": main_launches["walk_ragged"],
            "max_abs_err": walk_ragged_err,
            "shape": f"the 1024-pair DNA chunk in one walk_ragged launch, "
                     f"longest walk {dna_rr['longest_walk']} steps, device time",
            "ms": dna_rr["walk_ms"],
            "plain_ms": dna_rr["walk_plain_ms"],
            "plain_shape": "the walk pair by pair on the host, the whole chunk",
            "bound_ms": dna_rr["walk_bound_ms"],
            "bound_by": dna_rr["walk_bound_by"],
            "bound_note": "latency: the longest walk's chain of dependent "
                          "code loads, each from shared memory, plus one L2 "
                          "latency",
            "bound_in_place_ms": dna_rr["walk_bound_in_place_ms"],
            "library_ms": None,
            "per_bucket_launches_ms": dna_rr["per_bucket_walks_ms"],
            "blosum62_chunk_ms": blosum_rr["walk_ms"],
            "blosum62_chunk_bound_ms": blosum_rr["walk_bound_ms"],
            "blosum62_per_bucket_launches_ms": blosum_rr["per_bucket_walks_ms"],
        },
        {
            "name": "tokenize_ragged",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/tokenize.cu",
            "replaces": "native/runtime.cpp:159",
            "replaces_note": "ga_tokenize, the JAX package's host tokenize "
                             "(not a Pallas kernel); in the port the numpy "
                             "encode a bucket, batch._encode_bucket",
            "launches": main_launches["tokenize_ragged"],
            "launches_note": "one an unsharded align_pairs call",
            "max_abs_err": packed_err,
            "shape": "the 1024-pair DNA chunk's letters (1 byte each) into "
                     f"its {len(packed_rec['dna']['call'].slots)} buckets' "
                     "token rows, one launch, device time",
            "ms": packed_rec["dna"]["tokenize_ms"],
            "plain_ms": packed_rec["dna"]["tokenize_plain_ms"],
            "plain_shape": "tokenize_plain on the card, the same tensors",
            "bound_ms": packed_rec["dna"]["tokenize_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "blosum62_chunk_ms": packed_rec["blosum62"]["tokenize_ms"],
            "numpy_encode_ms": packed_rec["dna"]["numpy_encode_ms"],
            "ptxas": {k: v for k, v in letters_regs.items()
                      if k.startswith("tokenize")},
        },
        {
            "name": "render_ragged",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/render.cu",
            "replaces": "native/runtime.cpp:227",
            "replaces_note": "ga_render_ops, the JAX package's host render "
                             "(globalign_tpu/batch.py:1097; not a Pallas "
                             "kernel); in the port linear_tb.render_many",
            "launches": main_launches["render_ragged"],
            "launches_note": "one a traceback segment",
            "max_abs_err": packed_err,
            "shape": "the 1024-pair DNA chunk's one traceback segment, its "
                     "offsets (torch.cumsum) and one launch, device time",
            "ms": packed_rec["dna"]["render_ms"],
            "plain_ms": packed_rec["dna"]["render_plain_ms"],
            "plain_shape": "render_plain on the card, the same tensors",
            "bound_ms": packed_rec["dna"]["render_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "blosum62_chunk_ms": packed_rec["blosum62"]["render_ms"],
            "numpy_fetch_and_render_ms": packed_rec["dna"][
                "numpy_fetch_and_render_ms"],
            "ptxas": {k: v for k, v in letters_regs.items()
                      if k.startswith("render")},
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def multi_card() -> int:
    """``python3 chip_smoke.py --cards``: the parallel layer over NCCL, one
    rank a card on every card of the machine — the path that exists only
    across cards.  The jobs of phase 2's gloo ranks (a 50 000^2 DNA and a
    20 000^2 BLOSUM62 ``sharded_pair_cost``, ``align_blocked(mesh=)`` at
    20 000^2, ``align_pairs(mesh=)`` on a 1024-pair DNA chunk, both modes),
    every rank against the unsharded path on cuda:0, with the strip-mode
    launches a rank and the exchange time a super-step."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two or more CUDA devices",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from globalign_tpu_torch import align_pairs, find_global_alignment
    from globalign_tpu_torch.models.gotoh import GotohAligner
    from globalign_tpu_torch.parallel import seqpar
    from globalign_tpu_torch.utils import cuda_build
    from globalign_tpu_torch.config import resolve_scheme

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log("; ".join(smi))
    cuda_build.build()
    rng = np.random.default_rng(SEED)
    cards = torch.cuda.device_count()

    def pair_of(letters, size):
        s1 = random_seq(rng, letters, size)
        return s1, mutate(rng, s1, letters)

    big, blosum, blocked = (pair_of(DNA, 50_000), pair_of(PROTEIN, 20_000),
                            pair_of(DNA, 20_000))
    chunk = serving_chunk(rng, DNA, 1024, 819, 1024)
    seqs = ["".join(x) for x in zip(*chunk)]
    want = [
        GotohAligner(resolve_scheme(*big), device="cuda").cost(*big),
        GotohAligner(resolve_scheme(*blosum, scoring_mat_name="BLOSUM62"),
                     device="cuda").cost(*blosum),
        find_global_alignment(seq_1=blocked[0], seq_2=blocked[1]),
        [(r.cost, r.score, None, None, None)
         for r in align_pairs(chunk, with_traceback=False)],
        [(r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
         for r in align_pairs(chunk, with_traceback=True)],
    ]
    jobs = [
        ("cost", dict(pair=big, scheme_seqs=list(big), scheme_kw={})),
        ("cost", dict(pair=blosum, scheme_seqs=list(blosum),
                      scheme_kw=dict(scoring_mat_name="BLOSUM62"))),
        ("blocked", dict(pair=blocked, scheme_seqs=list(blocked), scheme_kw={})),
        ("pairs", dict(pairs=chunk, traceback=False, scheme_seqs=seqs,
                       scheme_kw={})),
        ("pairs", dict(pairs=chunk, traceback=True, scheme_seqs=seqs,
                       scheme_kw={})),
    ]
    t0 = time.perf_counter()
    answers = spawn_ranks(cards, jobs, timeout=600, backend="nccl")
    log(f"cards: {cards} NCCL ranks spawned, ran and joined in "
        f"{time.perf_counter() - t0:.3f} s")
    rb = seqpar.DEFAULT_BLOCK_ROWS
    for rank, (c_big, c_blosum, c_blocked, p_cost, p_tb) in enumerate(answers):
        cost_b, s1a, mid, s2a = c_blocked["out"]
        report = want[2]._replace(seq_1_aligned=s1a, middle_part=mid,
                                  seq_2_aligned=s2a, cost=cost_b)
        ok = (
            min(c_big["out"]) == want[0] and min(c_blosum["out"]) == want[1]
            and str(report) == str(want[2])
            and [tuple(x) for x in p_cost["out"]] == want[3]
            and [tuple(x) for x in p_tb["out"]] == want[4]
            and c_big["launches"]["strip_fill_block"] == -(-50_000 // rb)
            and c_blosum["launches"]["strip_fill_block"] == -(-20_000 // rb)
        )
        if not ok:
            raise SystemExit(f"cards failed: NCCL rank {rank} differs from "
                             "the unsharded path")
        shifts = c_big["shift_s"]
        log(f"cards: rank {rank} (cuda:{rank}): every job = the unsharded "
            f"path on cuda:0; seconds a job "
            f"{[round(a['seconds'], 4) for a in answers[rank]]}; 50000^2 "
            f"exchange median {1e3 * float(np.median(shifts)):.4f} ms over "
            f"{len(shifts)} super-steps; launches "
            f"{[a['launches'] for a in answers[rank]]}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards,
    }}))
    return 0


def wide_sweep(card: str, reps: int = 5) -> list[dict]:
    """The wide route's rule on the card (``fill_tile.route_buckets``): B
    wide BLOSUM62 pairs, each a bucket of its own as in a call's tail (B in
    1 .. 64, sides drawn from 1056 .. S for S = 1536, 2560 and 4096; cost
    only), and one bucket of B pairs of S^2 (S = 2048 and 4096, B = 16 to
    132: the mesh path's shards, past the path-bound test), through
    ``batch_final3_ragged`` with the route forced to one gotoh_tile launch
    and set aside (each bucket on ``fill_cuda``'s route: gotoh_tile for
    one or two pairs from 1024^2, gotoh_fill else), in turns: device time
    (``device_ms``: the host's enqueue hidden) and the call's time on the
    host clock to the card's end (median of ``reps``), beside the route's
    choice and the launch's model (path and tiles, path-bound or not).
    final3 equal both ways; one line a point, and the rows."""
    import torch

    from globalign_tpu_torch import resolve_scheme
    from globalign_tpu_torch.ops import fill_batch, fill_tile

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scheme = resolve_scheme(PROTEIN, PROTEIN, scoring_mat_name="BLOSUM62")
    cost = torch.from_numpy(np.ascontiguousarray(scheme.costing.values,
                                                 np.int32)).to(dev)
    letters = np.asarray(scheme.alphabet.encode(PROTEIN), np.int32)
    rng = np.random.default_rng(SEED + 18)

    def wall_ms(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    real = fill_tile.route_buckets
    routes = {"one launch": lambda buckets, _: list(range(len(buckets))),
              "per bucket": lambda *_: []}

    def tokens(nb, k):
        return torch.from_numpy(np.concatenate(
            [np.zeros((nb, 1), np.int32),
             rng.choice(letters, (nb, k)).astype(np.int32)], axis=1)).to(dev)

    points = [(f"sides 1056..{top}", nb, top, False)
              for top in (1536, 2560, 4096) for nb in (1, 2, 4, 8, 16, 32, 64)]
    points += [(f"one bucket of {side}^2", nb, side, True)
               for side, nbs in ((2048, (33, 66, 132)), (4096, (16, 32, 64)))
               for nb in nbs]
    rows = []
    try:
        for label, nb, top, one_bucket in points:
            if one_bucket:
                dims = [(top, top)] * nb
                ta, tb = tokens(nb, top), tokens(nb, top)
                args = ([ta], [tb], cost, scheme.alphabet.gap_id,
                        scheme.gap_open_cost, [[top] * nb], [[top] * nb])
                buckets = [([top] * nb, [top] * nb)]
            else:
                dims = [tuple(int(x) for x in rng.integers(1056, top + 1, 2))
                        for _ in range(nb)]
                tok = [(tokens(1, m), tokens(1, n)) for m, n in dims]
                args = ([a for a, _ in tok], [b for _, b in tok], cost,
                        scheme.alphabet.gap_id, scheme.gap_open_cost,
                        [[m] for m, _ in dims], [[n] for _, n in dims])
                buckets = [([m], [n]) for m, n in dims]
            fill_tile.route_buckets = real
            chosen = bool(real(buckets, sms))
            shape = fill_tile.plan(dims, False, sms)
            mdl = fill_tile.model(dims, shape, False, sms)
            row = dict(batch=nb, pairs=label, route="one launch" if chosen
                       else "per bucket", shape=list(shape),
                       path_tiles=mdl.path_tiles, tiles=mdl.tiles,
                       path_bound=mdl.tiles <= fill_tile.WARPS * sms
                       * mdl.path_tiles, device_ms={}, wall_ms={})
            finals = {}
            for turn in (*routes, *list(routes)[::-1]):
                fill_tile.route_buckets = routes[turn]
                fn = functools.partial(fill_batch.batch_final3_ragged, *args)
                row["device_ms"].setdefault(turn, []).append(device_ms(fn, reps))
                row["wall_ms"].setdefault(turn, []).append(wall_ms(fn))
                finals[turn] = fn()
            if not torch.equal(*finals.values()):
                raise SystemExit(f"wide sweep: the routes differ at B={nb}, "
                                 f"{label}")
            rows.append(row)
            log(f"phase 3: wide sweep B={nb}, {label} on {card} "
                f"(two turns each): one launch device "
                f"{row['device_ms']['one launch']} ms, wall "
                f"{row['wall_ms']['one launch']} ms; per bucket device "
                f"{row['device_ms']['per bucket']} ms, wall "
                f"{row['wall_ms']['per bucket']} ms; model path "
                f"{mdl.path_tiles} tiles of {mdl.tiles} at {list(shape)}, "
                f"path-bound {row['path_bound']}; route {row['route']}")
    finally:
        fill_tile.route_buckets = real
    return rows


def walk_ab(sources: list[str], reps: int = 10) -> int:
    """Time the package's walk kernels beside other builds of
    ``walk_block.cu`` (an older checkout's, or an edited copy: any source
    with the same two launchers), one ``nvcc`` each, all at once.

    Three seeded DNA shapes of the port's paths: a 10 000^2 pair (seq_2 a
    relative) walked by ``walk_block_launch`` from (m, n), the single-pair
    ``align``'s walk; the largest traceback bucket of a 1024-pair chunk
    (lengths 819-1024), the mesh path's ``walk_block``; and the chunk packed
    by ``batch_moves_ragged``, ``align_pairs``' one ``walk_ragged_launch``.
    Device time (``device_ms``), every build once in order and once in
    reverse, so a drift of the card shows as a gap between the two turns;
    every build's outputs held against the plain walk at tolerance 0.  One
    JSON line a build and shape after the card's name and power limit.
    """
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from globalign_tpu_torch import resolve_scheme
    from globalign_tpu_torch.batch import bucket_length
    from globalign_tpu_torch.ops import fill_cuda, linear_tb
    from globalign_tpu_torch.utils import cuda_build
    from globalign_tpu_torch.utils.tokenize import encode_padded

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda", 0)
    out_dir = cuda_build.BUILD_DIR / "walk_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k, src in enumerate(sources):
        so = out_dir / f"lib{k}.so"
        jobs.append((src, so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {"package": cuda_build.load()}
    for src, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"walk_ab: nvcc failed for {src}\n{out}")
        lib = ctypes.CDLL(str(so))
        for name in ("walk_block_launch", "walk_ragged_launch"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = cuda_build.SIGNATURES["walk_block"][name]
        libs[src] = lib

    rng = np.random.default_rng(SEED)
    scheme = resolve_scheme(DNA, DNA)
    fill = (torch.from_numpy(np.ascontiguousarray(
        scheme.costing.values, dtype=np.int32)).to(dev),
        scheme.alphabet.gap_id, scheme.gap_open_cost)

    def tokens_of(seqs, length):
        return torch.from_numpy(np.stack(
            [encode_padded(scheme.alphabet, s, length) for s in seqs])).to(dev)

    s1 = random_seq(rng, DNA, 10_000)
    groups = {}
    for a, b in serving_chunk(rng, DNA, 1024, 819, 1024):
        groups.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                          []).append((a, b))
    (mm, nn), largest = max(groups.items(), key=lambda kv: len(kv[1]))
    blocks = {}  # shape -> (moves, i_entry, j_entry, level_entry)
    for shape, pairs, M, N in (
            ("10000^2", [(s1, mutate(rng, s1, DNA))], 10_000, 10_000),
            ("bucket", largest, mm, nn)):
        mt, nt = [len(a) for a, _ in pairs], [len(b) for _, b in pairs]
        final3, moves = fill_cuda.batch_moves(
            tokens_of([a for a, _ in pairs], M),
            tokens_of([b for _, b in pairs], N), *fill, mt, nt)
        blocks[shape] = (moves, torch.tensor(mt, dtype=torch.int32, device=dev),
                         torch.tensor(nt, dtype=torch.int32, device=dev),
                         final3.argmin(-1).to(torch.int32))
    keys = list(groups)
    filled = fill_cuda.batch_moves_ragged(
        [tokens_of([a for a, _ in groups[k]], k[0]) for k in keys],
        [tokens_of([b for _, b in groups[k]], k[1]) for k in keys], *fill,
        [[len(a) for a, _ in groups[k]] for k in keys],
        [[len(b) for _, b in groups[k]] for k in keys])
    lay = filled.layout
    length = int((lay[:, 2] + lay[:, 3]).max())
    want = {shape: linear_tb.walk_block(mv.cpu(), i_e.cpu(), j_e.cpu(), lv.cpu())
            for shape, (mv, i_e, j_e, lv) in blocks.items()}
    want["chunk"] = linear_tb.walk_ragged(fill_cuda.RaggedMoves(
        filled.final3.cpu(), filled.codes.cpu(), filled.desc.cpu(), lay))

    def launcher(lib, shape):
        """The raw launch of one build on one shape, and its outputs."""
        stream = torch.cuda.current_stream().cuda_stream
        if shape == "chunk":
            outs = (torch.zeros((len(lay), length), dtype=torch.uint8, device=dev),
                    *(torch.empty(len(lay), dtype=torch.int32, device=dev)
                      for _ in range(2)))
            args = (filled.desc, filled.codes, filled.final3, *outs)
            fn, ints = lib.walk_ragged_launch, (len(lay), length)
        else:
            moves, i_e, j_e, lv = blocks[shape]
            batch, k1, n1 = moves.shape
            outs = (torch.zeros((batch, k1 + n1 - 2), dtype=torch.uint8,
                                device=dev),
                    *(torch.empty(batch, dtype=torch.int32, device=dev)
                      for _ in range(3)))
            args = (moves, i_e, j_e, lv, *outs)
            fn, ints = lib.walk_block_launch, (batch, k1 - 1, n1 - 1, k1 + n1 - 2)

        def run():
            err = fn(*(x.data_ptr() for x in args), *ints, stream)
            if err:
                raise SystemExit(f"walk_ab: launch failed, CUDA error {err}")
        return run, outs

    results = {}
    for name in list(libs) + list(libs)[::-1]:
        for shape in ("10000^2", "bucket", "chunk"):
            run, got = launcher(libs[name], shape)
            ms = device_ms(run, reps)
            torch.cuda.synchronize()
            if any(not torch.equal(g.cpu(), w) for g, w in zip(got, want[shape])):
                raise SystemExit(f"walk_ab: {name} on {shape} != the plain walk")
            results.setdefault((name, shape), []).append(ms)
    for (name, shape), times in results.items():
        print(json.dumps(dict(
            source=name, shape=shape, ms=times,
            longest_walk=int(want[shape][1].max()),
            pairs=int(want[shape][1].numel()), max_abs_err=0, card=card)),
            flush=True)
    return 0


def wide_sweep_main() -> int:
    """``--wide-sweep``: the card's line, then :func:`wide_sweep` alone and
    its rows as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    print(json.dumps({"wide_sweep": wide_sweep(f"({card})"), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--walk-ab"]:
        sys.exit(walk_ab(sys.argv[2:]))
    if sys.argv[1:] == ["--wide-sweep"]:
        sys.exit(wide_sweep_main())
    sys.exit(multi_card() if sys.argv[1:] == ["--cards"] else main())
