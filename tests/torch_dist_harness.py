"""Ranks of a gloo process group on the CPU, for the port's parallel tests.

``run_ranks`` starts ``world`` Python processes, each a rank of one gloo
group (a file store under the test's directory, so parallel test workers
never share a port), hands every rank the same list of cases, and returns
each rank's answers.  A rank imports the port and never JAX: the parent test
computes the JAX package's answers and compares.

Each case is a dict with a ``kind`` (a function below) and its arguments,
JSON-friendly: tokens and cost matrices as lists, schemes as the keyword
arguments of ``resolve_scheme``, and ``device`` ("cpu" by default; gloo
ranks on one card all take "cuda").  Each rank also records the strip-mode
launches of each case (:func:`strip_launches`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_ranks(tmp_path, world: int, cases: list, timeout: float = 180.0,
              env: dict | None = None) -> list:
    """Each rank's answers to ``cases``, rank by rank; fails if any rank
    fails or outlives ``timeout`` seconds."""
    spec = Path(tmp_path) / f"spec-{world}.json"
    spec.write_text(json.dumps({
        "cases": cases,
        "store": f"file://{Path(tmp_path) / f'store-{world}'}",
        "out": str(tmp_path),
    }))
    run_env = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__)), str(spec), str(rank),
             str(world)],
            cwd=REPO, env=run_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for rank in range(world)
    ]
    try:
        errors = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, err) in enumerate(zip(procs, errors)):
        assert p.returncode == 0, f"rank {rank}: {err[-3000:]}"
    return [_rank_file(tmp_path, rank, world)["answers"] for rank in range(world)]


def strip_launches(tmp_path, world: int) -> list:
    """Each rank's ``strip_fill_block`` launches a case, after
    :func:`run_ranks`."""
    return [_rank_file(tmp_path, rank, world)["strip_launches"]
            for rank in range(world)]


def _rank_file(tmp_path, rank: int, world: int) -> dict:
    return json.loads((Path(tmp_path) / f"rank{rank}-{world}.json").read_text())


# -- the rank's side ------------------------------------------------------


def _tensors(case, *names):
    import torch

    return [torch.tensor(case[k], dtype=torch.int32,
                         device=case.get("device", "cpu")) for k in names]


def pair_cost(mesh, case):
    from globalign_tpu_torch.parallel import seqpar

    ta, tb, cost = _tensors(case, "tok_a", "tok_b", "cost")
    out = seqpar.sharded_pair_cost(
        mesh, ta, tb, cost, case["gap_id"], case["gap_open"],
        block_rows=case["block_rows"],
    )
    return out.tolist()


def block_last_rows(mesh, case):
    from globalign_tpu_torch.parallel import seqpar

    ta, tb, cost, row0, col0 = _tensors(
        case, "tok_a", "tok_b", "cost", "row0", "col0"
    )
    out = seqpar.sharded_block_last_rows(
        mesh, ta, tb, cost, case["gap_id"], case["gap_open"], row0, col0,
        block_rows=case["block_rows"],
    )
    return out.tolist()


def align_blocked(mesh, case):
    import torch

    from globalign_tpu_torch.config import resolve_scheme
    from globalign_tpu_torch.ops import linear_tb

    s1, s2 = case["s1"], case["s2"]
    scheme = resolve_scheme(s1, s2, **case.get("scheme", {}))

    device = case.get("device", "cpu")

    def enc(s):
        tok = [0] + list(scheme.alphabet.encode(s))
        return torch.tensor(tok, dtype=torch.int32, device=device)

    cost = torch.tensor(scheme.costing.values, dtype=torch.int32, device=device)
    tb = linear_tb.align_blocked(
        enc(s1), enc(s2), cost, scheme.alphabet.gap_id, scheme.gap_open_cost,
        s1, s2, block_rows=case.get("block_rows"), mesh=mesh,
    )
    return [tb.cost, tb.seq_1_aligned, tb.middle_part, tb.seq_2_aligned]


def align_pairs(mesh, case):
    from globalign_tpu_torch.batch import align_pairs as run

    results = run(
        [tuple(p) for p in case["pairs"]], with_traceback=case["traceback"],
        device=case.get("device", "cpu"), mesh=mesh, **case.get("scheme", {}),
    )
    return [
        [r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned]
        for r in results
    ]


def runner(mesh, case):
    import io

    from globalign_tpu_torch.runner import BatchRunner

    log = io.StringIO()
    stats = BatchRunner(
        output=Path(case["output"]), chunk_pairs=case["chunk_pairs"],
        with_traceback=case["traceback"], emit_cigar=case["traceback"],
        device="cpu", mesh=mesh, log=log,
    ).run([tuple(p) for p in case["pairs"]])
    return {"pairs": stats.pairs, "chunks": stats.chunks,
            "logged": bool(log.getvalue())}


def main() -> int:
    spec_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    spec = json.loads(Path(spec_path).read_text())
    import torch.distributed as dist

    from globalign_tpu_torch.ops import fill_cuda
    from globalign_tpu_torch.parallel import make_pair_mesh, multihost

    multihost.initialize(spec["store"], world, rank, backend="gloo")
    try:
        mesh = make_pair_mesh()
        kinds = {f.__name__: f for f in
                 (pair_cost, block_last_rows, align_blocked, align_pairs, runner)}
        answers, strips = [], []
        for case in spec["cases"]:
            before = fill_cuda.strip_fill_block.launches
            answers.append(kinds[case["kind"]](mesh, case))
            strips.append(fill_cuda.strip_fill_block.launches - before)
        jax_loaded = sorted(
            m for m in sys.modules if m.split(".")[0] in ("jax", "globalign_tpu")
        )
        if jax_loaded:
            raise RuntimeError(f"a rank imported {jax_loaded}")
    finally:
        dist.destroy_process_group()
    out = Path(spec["out"]) / f"rank{rank}-{world}.json"
    out.write_text(json.dumps({"answers": answers, "strip_launches": strips}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
