"""Batch command-line front end: ``python -m globalign_tpu_torch.batch_cli``.

The port of ``globalign_tpu/batch_cli.py``: stream pairs from a file, align
them in resumable chunks on the card, append results to a TSV, journal
completed chunks for preemption-safe resume (see
:mod:`globalign_tpu_torch.runner`).  The results TSV and the manifest are
the JAX package's, byte for byte.

Scheme options mirror the single-pair CLI; input is either a FASTA file of
consecutive record pairs or a two-column TSV of raw sequences.
``--device {cuda,cpu}`` (default cuda, which raises without a GPU) takes
the place of ``--platform``.  ``--fuse_chunks`` is refused: the JAX
package's opt-in chunk fusion is always on here (a call's cost buckets fill
together, its traceback buckets fill and walk together), so the switch has
nothing to switch.

Multi-process runs (``parallel.multihost``): one process per card, each a
rank of a ``torch.distributed`` group — ``--distributed`` with
``--coordinator_address`` / ``--num_processes`` / ``--process_id`` (the
rank), or under torchrun.  A JAX process drives its host's chips; here the
ranks of one host stand together for it:

  * ``--distributed`` alone deals the chunks round-robin over the ranks,
    each appending to its own ``<output>.part<rank>``;
  * ``--distributed --shard`` groups the ranks by host (torchrun's
    ``LOCAL_WORLD_SIZE``, else the host name), deals the chunks over the
    hosts, and shards each chunk over the host's ranks in lockstep
    (``align_pairs(mesh=)``); the host's first rank writes
    ``<output>.part<host>``;
  * ``--shard`` alone is a world of one, the production shape on one card.

``--backend`` picks NCCL (the default with ``--device cuda``; one card per
rank) or gloo (the default with ``--device cpu``; ranks may share a card,
their exchanges staged through host memory).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpalign-batch",
        description=(
            "Align many sequence pairs on a GPU with length bucketing, "
            "resumable chunking, and throughput metrics."
        ),
    )
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--pairs_fasta",
        help="FASTA file; consecutive records form pairs (1&2, 3&4, ...).",
    )
    src.add_argument(
        "--pairs_tsv", help="TSV file with 'seq1<TAB>seq2' per line."
    )
    parser.add_argument(
        "-o",
        "--output",
        required=True,
        help=(
            "Results TSV (appended): idx, cost, score, plus the three "
            "alignment lines with --with_traceback.  A manifest journal at "
            "<output>.manifest.jsonl makes reruns resume instead of redoing "
            "completed chunks."
        ),
    )
    parser.add_argument(
        "--with_traceback",
        action="store_true",
        help="Also emit the aligned strings (move codes walked on the device).",
    )
    parser.add_argument(
        "--cigar",
        action="store_true",
        help="Append a CIGAR column ('='/'X'/'I'/'D'); implies --with_traceback.",
    )
    parser.add_argument("--chunk_pairs", type=int, default=1024)
    parser.add_argument("--bucket_quantum", type=int, default=32)
    parser.add_argument(
        "--fresh",
        action="store_true",
        help="Ignore and truncate any existing output/manifest (no resume).",
    )
    parser.add_argument(
        "--shard",
        action="store_true",
        help=(
            "Shard each chunk's batch data-parallel over this host's ranks "
            "(cost AND traceback modes: final lanes, op tapes are "
            "all-gathered; move codes stay on each rank's card).  Without "
            "--distributed: a world of one."
        ),
    )
    # Scheme options (same semantics as the single-pair CLI).
    parser.add_argument(
        "--scoring_mat_name", choices=["BLOSUM50", "BLOSUM62"]
    )
    parser.add_argument("--scoring_mat_path")
    parser.add_argument("--match_score")
    parser.add_argument("--mismatch_score")
    parser.add_argument("--mismatch_cost")
    parser.add_argument("--gap_open_score")
    parser.add_argument("--gap_open_cost")
    parser.add_argument("--gap_extension_score")
    parser.add_argument("--gap_extension_cost")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Run on the GPU (default; fails without one) or on the CPU "
        "with the plain PyTorch engine.",
    )
    # Multi-process execution (one process per card): every process runs
    # this CLI with the same input and its own --process_id (its rank).
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="Join a torch.distributed process group (multi-process run).",
    )
    parser.add_argument(
        "--coordinator_address",
        help="host:port of rank 0 (omit under torchrun: env://).",
    )
    parser.add_argument("--num_processes", type=int)
    parser.add_argument("--process_id", type=int)
    parser.add_argument(
        "--backend",
        choices=["nccl", "gloo"],
        help="Process-group backend (default: nccl with --device cuda, "
        "gloo with --device cpu).",
    )
    parser.add_argument(
        "--profile_dir",
        help="Write a torch.profiler trace of the run (Chrome trace JSON) "
        "into this directory.",
    )
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if backend == "nccl" and args.device == "cpu":
        parser.error("--backend nccl moves CUDA tensors; use gloo with --device cpu")
    if not (args.distributed or args.shard):
        return _run(args, None, 0, 1)

    import torch.distributed as dist

    from .parallel import multihost
    from .parallel.mesh import make_pair_mesh

    rank, world = multihost.initialize(
        args.coordinator_address,
        args.num_processes if args.distributed else 1,
        args.process_id,
        backend=backend,
    )
    try:
        if args.shard:
            host, hosts, group = multihost.host_group()
            return _run(args, make_pair_mesh(group), host, hosts)
        return _run(args, None, rank, world)
    finally:
        dist.destroy_process_group()


def _run(args, mesh, process_id: int, num_processes: int) -> int:
    """Align the input with the runner: ``mesh`` (or None) shards each
    chunk; ``process_id`` of ``num_processes`` owns its share of chunks."""
    from .parallel import comm
    from .runner import BatchRunner, pairs_from_fasta, pairs_from_tsv

    scheme_keys = (
        "scoring_mat_name",
        "scoring_mat_path",
        "match_score",
        "mismatch_score",
        "mismatch_cost",
        "gap_open_score",
        "gap_open_cost",
        "gap_extension_score",
        "gap_extension_cost",
    )
    scheme_kwargs = {
        k: getattr(args, k) for k in scheme_keys if getattr(args, k) is not None
    }

    runner = BatchRunner(
        output=Path(args.output),
        scheme_kwargs=scheme_kwargs,
        chunk_pairs=args.chunk_pairs,
        bucket_quantum=args.bucket_quantum,
        with_traceback=args.with_traceback or args.cigar,
        emit_cigar=args.cigar,
        device=args.device,
        mesh=mesh,
        process_id=process_id,
        num_processes=num_processes,
    )
    if args.fresh and runner.writer:
        runner.output.unlink(missing_ok=True)
        runner.manifest_path.unlink(missing_ok=True)
    if args.fresh and mesh is not None:
        comm.barrier(mesh)  # no rank reads the manifest before it is gone
    pairs = (
        pairs_from_fasta(args.pairs_fasta)
        if args.pairs_fasta
        else pairs_from_tsv(args.pairs_tsv)
    )

    if args.profile_dir:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            runner.run(pairs)
        trace_dir = Path(args.profile_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
    else:
        runner.run(pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
